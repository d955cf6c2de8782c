"""Pileup data model and the BAM->pileup ingest sweep.

Mirrors sc_dropseq_lib_t (sc_drop_seq.h:21-58, sc_drop_seq.cpp) and the main
ingest loop (cmd_cram_demuxlet.cpp:195-361): for each MQ/flag-passing read,
extract barcode (tag-group) and UMI (tag-UMI), walk the CIGAR once per
overlapping SNP, apply BQ/tail-distance filters, dedup on (snp, cell, UMI)
with first-occurrence-wins, and maintain the reference's read-accounting
counters exactly.

The (snp,cell)->*(umi -> packed obs)* maps become, for the device engine,
dense count tensors C[cell, snp, allele, bq] via to_counts() — valid because
both likelihood recursions telescope (SURVEY.md §7): per-(cell,snp)
likelihoods depend only on the multiset of (allele, BQ) observations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from demuxlet_tpu_torch.io.bam import READ_INDEX_NA, AlignmentReader
from demuxlet_tpu_torch.io.vcf import SnpTable
from demuxlet_tpu_torch.utils.logging_utils import notice


class PileupData:
    """In-memory pileup: mirrors sc_dropseq_lib_t with dual (snp,cell) index."""

    def __init__(self, sample_ids: List[str], snp_gps: List[np.ndarray]):
        self.sample_ids = list(sample_ids)
        self.snp_gps = snp_gps  # list of (nv, 3) float64
        self.barcodes: List[str] = []
        self.bc_map: Dict[str, int] = {}
        self.cell_totl: List[int] = []
        self.cell_pass: List[int] = []
        self.cell_uniq: List[int] = []
        # (snpid, cellid) -> {umi: (allele, bq)}
        self.umis: Dict[Tuple[int, int], Dict[str, Tuple[int, int]]] = {}
        self._snp_cells: Dict[int, set] = {}
        self._cell_snps: Dict[int, set] = {}

    @property
    def nsnps(self) -> int:
        return len(self.snp_gps)

    @property
    def nbcs(self) -> int:
        return len(self.barcodes)

    @property
    def nv(self) -> int:
        return len(self.sample_ids)

    def add_cell(self, barcode: str) -> int:
        i = self.bc_map.get(barcode)
        if i is not None:
            return i
        i = len(self.barcodes)
        self.bc_map[barcode] = i
        self.barcodes.append(barcode)
        self.cell_totl.append(0)
        self.cell_pass.append(0)
        self.cell_uniq.append(0)
        return i

    def add_read(self, snpid: int, cellid: int, umi: str, allele: int, bq: int) -> bool:
        """sc_drop_seq.cpp:34-77: returns True if (snp,cell,umi) was new."""
        self.cell_pass[cellid] += 1
        key = (snpid, cellid)
        d = self.umis.get(key)
        if d is None:
            d = {}
            self.umis[key] = d
            self._snp_cells.setdefault(snpid, set()).add(cellid)
            self._cell_snps.setdefault(cellid, set()).add(snpid)
        if umi in d:
            return False
        d[umi] = (allele, bq)
        self.cell_uniq[cellid] += 1
        return True

    # ---- iteration orders reproducing the reference's std::map semantics ----

    def snp_cells(self, snpid: int) -> List[int]:
        return sorted(self._snp_cells.get(snpid, ()))

    def cell_snps(self, cellid: int) -> List[int]:
        return sorted(self._cell_snps.get(cellid, ()))

    def n_cell_snps(self, cellid: int) -> int:
        return len(self._cell_snps.get(cellid, ()))

    def sorted_umis(self, snpid: int, cellid: int) -> List[Tuple[int, int]]:
        d = self.umis[(snpid, cellid)]
        return [d[u] for u in sorted(d.keys())]

    def bc_order(self) -> List[Tuple[str, int]]:
        return sorted(self.bc_map.items())

    # ---- dense/COO exports for the device engine ----

    def to_coo(
        self,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """COO count arrays: (cell, snp, allele, bq) -> count of unique UMIs.

        allele==2 observations are dropped (skipped by every likelihood loop,
        cmd_cram_demuxlet.cpp:435,604).
        """
        counts: Dict[Tuple[int, int, int, int], int] = {}
        for (s, c), d in self.umis.items():
            for al, bq in d.values():
                if al == 2:
                    continue
                k = (c, s, al, bq)
                counts[k] = counts.get(k, 0) + 1
        items = sorted(counts.items())
        if not items:
            return (
                np.zeros(0, np.int32),
                np.zeros(0, np.int32),
                np.zeros(0, np.int8),
                np.zeros(0, np.int16),
                np.zeros(0, np.int32),
            )
        keys = np.array([k for k, _ in items], dtype=np.int64)
        cnt = np.array([v for _, v in items], dtype=np.int32)
        return keys[:, 0].astype(np.int32), keys[:, 1].astype(np.int32), keys[
            :, 2
        ].astype(np.int8), keys[:, 3].astype(np.int16), cnt

    def coverage_mask(self) -> np.ndarray:
        """(nbcs, nsnps) bool: which (cell, snp) pairs have any UMI."""
        m = np.zeros((self.nbcs, self.nsnps), dtype=bool)
        for s, c in self.umis.keys():
            m[c, s] = True
        return m


@dataclass
class IngestCounters:
    """The reference's end-of-ingest accounting (cmd_cram_demuxlet.cpp:351-361)."""

    n_read: int = 0
    n_skip: int = 0
    n_skip_bcd: int = 0
    n_tmp: int = 0
    n_multi_snps: int = 0
    n_pass: int = 0
    n_redundant: int = 0
    n_lq: int = 0
    n_n: int = 0
    n_no_gtag: int = 0
    n_no_utag: int = 0

    def report(self, nbcs: int, nsnps: int) -> None:
        notice("Total number input reads : %d", self.n_read)
        notice("Total number valid droplets observed : %d", nbcs)
        notice("Total number valid SNPs observed     : %d", nsnps)
        notice(
            "Total number of read-QC-passed reads : %d ", self.n_read - self.n_skip
        )
        notice(
            "Total number of skipped reads with ignored barcodes : %d",
            self.n_skip_bcd,
        )
        notice(
            "Total number of non-skipped reads with considered barcodes : %d",
            self.n_tmp,
        )
        notice("Total number of gapped/noninformative reads : %d", self.n_n)
        notice("Total number of base-QC-failed reads : %d", self.n_lq)
        notice("Total number of redundant reads : %d", self.n_redundant)
        notice("Total number of pass-filtered reads : %d", self.n_pass)
        notice(
            "Total number of pass-filtered reads overlapping with multiple SNPs : %d",
            self.n_multi_snps,
        )


def build_pileup(
    reader: AlignmentReader,
    table: SnpTable,
    tag_group: str = "CB",
    tag_umi: str = "UB",
    cap_bq: int = 40,
    min_bq: int = 13,
    min_td: int = 0,
    group_set: Optional[set] = None,
    verbose_cells: bool = True,
    n_shards: int = 1,
    shard_id: int = 0,
    sam_verbose: int = 1000000,
    regions=None,
) -> Tuple[PileupData, IngestCounters]:
    """The ingest sweep (cmd_cram_demuxlet.cpp:195-338).

    Instead of the reference's synchronized sliding VCF buffer, the full
    filtered SNP table is pre-loaded and each read's candidate SNPs are found
    with a binary search over per-chromosome sorted positions — output-
    equivalent (see io/vcf.py docstring).

    regions: optional [(chrom, beg1, end0)] genome-shard ownership regions:
    per-cell counters only count reads starting inside them (observations
    are restricted by pre-filtering the SNP table to the same regions);
    the whole-scan n_read/n_skip totals remain file-wide.
    """
    scl = PileupData(table.sample_ids, [table.gps[i] for i in range(table.nsnps)])
    ctr = IngestCounters()

    # chromosome-order consistency check (cmd_cram_demuxlet.cpp:157-178)
    _check_chrom_order(reader.refs, table.chrom_names)

    # per-chromosome sorted SNP positions for binary search
    by_chrom: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    chrom_arr = np.asarray(table.chroms)
    for ch in table.chrom_names:
        idx = np.nonzero(chrom_arr == ch)[0]
        pos = table.pos0[idx]
        order = np.argsort(pos, kind="stable")
        by_chrom[ch] = (pos[order], idx[order].astype(np.int64))

    tid_to_chrom = {i: name for i, name in enumerate(reader.refs)}
    umi_counter = 0

    reg_by_chrom: Optional[Dict[str, list]] = None
    if regions:
        reg_by_chrom = {}
        for chrom, beg1, end0 in regions:
            reg_by_chrom.setdefault(chrom, []).append((beg1 - 1, end0))

    def owns(chrom: str, pos0: int) -> bool:
        if reg_by_chrom is None:
            return True
        for b0, e0 in reg_by_chrom.get(chrom, ()):
            if b0 <= pos0 < e0:
                return True
        return False

    for r in reader.filtered():
        ctr.n_read = reader.n_read
        ctr.n_skip = reader.n_skip
        if sam_verbose and reader.n_read % sam_verbose == 0:
            # sam_filtered_reader.cpp:182-189 progress notice
            notice(
                "Processing %d reads at %s:%d",
                reader.n_read,
                tid_to_chrom.get(r.tid, "?"),
                r.pos + 1,
            )
        chrom = tid_to_chrom.get(r.tid)
        if chrom is None or chrom not in by_chrom:
            continue
        owned = owns(chrom, r.pos)
        # barcode
        if not tag_group:
            ibcd = scl.add_cell(".")
        else:
            sbcd = r.tags.get(tag_group)
            if sbcd is None:
                if owned:
                    ctr.n_no_gtag += 1
                sbcd = "."
            if group_set is not None and sbcd not in group_set:
                if owned:
                    ctr.n_skip_bcd += 1
                continue
            if n_shards > 1 and not _owns(sbcd, shard_id, n_shards):
                if owned:
                    ctr.n_skip_bcd += 1
                continue
            ibcd = scl.add_cell(sbcd)
            if verbose_cells and ibcd + 1 == scl.nbcs and scl.nbcs % 1000 == 0:
                notice("Observed %d droplets with unique cell barcode", scl.nbcs)
        if owned:
            ctr.n_tmp += 1

        # UMI
        if not tag_umi:
            umi = "u%x" % umi_counter  # reference uses rand() hex (:276)
            umi_counter += 1
        else:
            umi = r.tags.get(tag_umi)
            if umi is None:
                if owned:
                    ctr.n_no_utag += 1
                umi = "."

        if owned:
            scl.cell_totl[ibcd] += 1

        pos_arr, snp_idx = by_chrom[chrom]
        endpos = r.endpos()
        lo = int(np.searchsorted(pos_arr, r.pos, side="left"))
        hi = int(np.searchsorted(pos_arr, endpos, side="left"))

        nv_pass = 0
        nv_redundant = 0
        nv_valid = 0
        for k in range(lo, hi):
            sid = int(snp_idx[k])
            ref_c = chr(table.ref[sid])
            alt_c = chr(table.alt[sid])
            # ref_c resolves CRAM match positions (VCF REF == genome base
            # at the SNP); BAM/SAM reads ignore it
            base, qual, rpos = r.base_qual_at(int(pos_arr[k]), ref_c)
            if rpos == READ_INDEX_NA:
                continue
            if base == "N":
                continue
            nv_valid += 1
            if qual < min_bq:
                continue
            if rpos < min_td - 1:
                continue
            if rpos + min_td > r.l_qseq:
                continue
            allele = 0 if base == ref_c else (1 if base == alt_c else 2)
            bq = cap_bq if qual > cap_bq else qual
            if scl.add_read(sid, ibcd, umi, allele, bq):
                nv_pass += 1
            else:
                nv_redundant += 1

        if owned:
            if nv_pass > 1:
                ctr.n_multi_snps += 1
            if nv_pass > 0:
                ctr.n_pass += 1
            elif nv_redundant > 0:
                ctr.n_redundant += 1
            elif nv_valid > 0:
                ctr.n_lq += 1
            else:
                ctr.n_n += 1

    ctr.n_read = reader.n_read
    ctr.n_skip = reader.n_skip
    return scl, ctr


def _owns(barcode: str, shard_id: int, n_shards: int) -> bool:
    """crc32 barcode striping (parallel/multihost.owns_barcode semantics)."""
    import zlib

    return (zlib.crc32(barcode.encode()) & 0xFFFFFFFF) % n_shards == shard_id


def _check_chrom_order(bam_refs: List[str], vcf_chroms: List[str]) -> None:
    """BAM<->VCF chromosome-order consistency (cmd_cram_demuxlet.cpp:157-178)."""
    from demuxlet_tpu_torch.utils.logging_utils import error

    vcf_order = {c: i for i, c in enumerate(vcf_chroms)}
    prev = -1
    matched = 0
    for name in bam_refs:
        rid = vcf_order.get(name)
        if rid is not None:
            if prev >= rid:
                error(
                    "Your VCF/BCF files and SAM/BAM/CRAM files have different "
                    "ordering of chromosomes (%s out of order)",
                    name,
                )
            prev = rid
            matched += 1
    if matched == 0:
        error(
            "Your VCF/BCF files and SAM/BAM/CRAM files does not have any "
            "matching chromosomes, or some chromosome names are duplicated"
        )
