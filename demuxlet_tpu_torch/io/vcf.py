"""VCF/BCF reading: streaming parse -> filtered, posterior-annotated SNP table.

Host-side replacement for the reference's BCFFilteredReader + BCFChunkedReader
stack (bcf_filtered_reader.cpp, bcf_chunked_reader.cpp). Unlike the reference
(which co-scans VCF and BAM with a sliding buffer), we load the full filtered
SNP table upfront: SNPs never covered by a read contribute exactly zero to
every likelihood, so the outputs are identical while the dense device kernels
get a static SNP axis.

Supports .vcf, .vcf.gz (gzip/BGZF) and .bcf (BCF2 binary, io/bcf.py).
"""

from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field
from typing import IO, Iterator, List, Optional, Sequence

import numpy as np

from demuxlet_tpu_torch.host import genotypes as G
from demuxlet_tpu_torch.utils.logging_utils import error, notice, warning

GT_MISSING = -1


@dataclass
class VariantRecord:
    chrom: str
    pos0: int  # 0-based position
    ref: str
    alts: List[str]
    qual: float
    filters: List[str]
    fmt_keys: List[str]
    # raw per-sample FORMAT strings, split per sample (lazily parsed fields)
    sample_fields: List[List[str]]

    @property
    def n_allele(self) -> int:
        return 1 + sum(1 for a in self.alts if a != ".")

    def gt_pairs(self, icols: Sequence[int]) -> np.ndarray:
        """(nsel, 2) allele indices, -1 for missing (htslib GT semantics)."""
        try:
            gi = self.fmt_keys.index("GT")
        except ValueError:
            return np.full((len(icols), 2), GT_MISSING, dtype=np.int32)
        out = np.full((len(icols), 2), GT_MISSING, dtype=np.int32)
        for r, i in enumerate(icols):
            fields = self.sample_fields[i]
            s = fields[gi] if gi < len(fields) else "."
            # split on / or |
            parts = s.replace("|", "/").split("/")
            for j in range(min(2, len(parts))):
                p = parts[j]
                if p and p != ".":
                    try:
                        out[r, j] = int(p)
                    except ValueError:
                        pass
        return out

    def int_field(self, name: str, icols: Sequence[int], per: int = 3) -> Optional[np.ndarray]:
        """(nsel, per) int32; missing -> INT32_MIN (htslib bcf_int32_missing)."""
        try:
            fi = self.fmt_keys.index(name)
        except ValueError:
            return None
        out = np.full((len(icols), per), np.iinfo(np.int32).min, dtype=np.int32)
        for r, i in enumerate(icols):
            fields = self.sample_fields[i]
            if fi >= len(fields):
                continue
            s = fields[fi]
            if s == "." or not s:
                continue
            for j, tok in enumerate(s.split(",")[:per]):
                if tok != ".":
                    try:
                        out[r, j] = int(tok)
                    except ValueError:
                        pass
        return out

    def float_field(self, name: str, icols: Sequence[int], per: int = 3) -> Optional[np.ndarray]:
        """(nsel, per) float32; missing -> NaN."""
        try:
            fi = self.fmt_keys.index(name)
        except ValueError:
            return None
        out = np.full((len(icols), per), np.nan, dtype=np.float32)
        for r, i in enumerate(icols):
            fields = self.sample_fields[i]
            if fi >= len(fields):
                continue
            s = fields[fi]
            if s == "." or not s:
                continue
            for j, tok in enumerate(s.split(",")[:per]):
                if tok != ".":
                    try:
                        out[r, j] = np.float32(tok)
                    except ValueError:
                        pass
        return out


def _open_text(path: str) -> IO[str]:
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return _io.TextIOWrapper(gzip.open(path, "rb"), encoding="utf-8")
    return open(path, "rt", encoding="utf-8")


class VcfReader:
    """Streaming VCF text reader: header + record iteration."""

    def __init__(self, path: str):
        self.path = path
        self.samples: List[str] = []
        self.contigs: List[str] = []
        self._fh = _open_text(path)
        self._parse_header()

    def _parse_header(self) -> None:
        for line in self._fh:
            line = line.rstrip("\n")
            if line.startswith("##"):
                if line.startswith("##contig="):
                    # ##contig=<ID=chr1,length=...>
                    inner = line[len("##contig=<") :].rstrip(">")
                    for kv in inner.split(","):
                        if kv.startswith("ID="):
                            self.contigs.append(kv[3:])
                continue
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.samples = cols[9:]
                return
        error("[%s] No #CHROM header line found", self.path)

    def __iter__(self) -> Iterator[VariantRecord]:
        for line in self._fh:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            yield _record_from_line(line)

    def iter_regions(self, regions) -> Optional[Iterator[VariantRecord]]:
        """Index-seeked iteration over [(chrom, beg1, end0)] regions via a
        .tbi (the reference analog: BCFChunkedReader's index jumps,
        bcf_chunked_reader.cpp:70-118): each region BGZF-seeks to its
        start window's virtual offset and parses only until past the
        region end, so a genome shard reads ~1/N of a large VCF. Returns
        None when the file isn't BGZF or no readable index exists (the
        caller full-scans + post-filters instead)."""
        import os

        tbi = self.path + ".tbi"
        if not (self.path.endswith(".gz") and os.path.exists(tbi)):
            return None
        if not self.contigs:
            # no ##contig header lines: a seeked parse could not preserve
            # the full contig list (load_snp_table's chrom_names override),
            # and genome-shard read-ownership accounting needs it — fall
            # back to the full scan + post-filter
            return None
        idx = _read_tabix(tbi)
        if idx is None:
            return None
        return self._iter_regions_tbi(idx, regions)

    def _iter_regions_tbi(self, idx, regions) -> Iterator[VariantRecord]:
        from demuxlet_tpu_torch.io.bgzf import iter_lines_from

        names, starts, linear = idx
        name_to_ref = {n: i for i, n in enumerate(names)}
        for chrom, beg1, end0 in regions:
            r = name_to_ref.get(chrom)
            if r is None or starts[r] == 0:
                continue
            voff = starts[r]
            win = (beg1 - 1) >> 14
            lin = linear[r]
            if win < len(lin) and lin[win]:
                voff = max(voff, lin[win])
            seen = False
            for line in iter_lines_from(self.path, voff):
                if not line or line.startswith("#"):
                    continue
                tab1 = line.find("\t")
                tab2 = line.find("\t", tab1 + 1)
                c = line[:tab1]
                if c != chrom:
                    if seen:
                        break  # coordinate-sorted: past this chromosome
                    continue  # index landed before the chrom start
                seen = True
                pos1 = int(line[tab1 + 1 : tab2])
                if pos1 > end0:
                    break
                if pos1 < beg1:
                    continue
                yield _record_from_line(line)

    def close(self) -> None:
        self._fh.close()


def _record_from_line(line: str) -> VariantRecord:
    cols = line.split("\t")
    chrom, pos, _id, ref, alt = cols[0], cols[1], cols[2], cols[3], cols[4]
    qual = float(cols[5]) if cols[5] != "." else float("nan")
    filters = [] if cols[6] in (".", "") else cols[6].split(";")
    fmt_keys = cols[8].split(":") if len(cols) > 8 else []
    sample_fields = [c.split(":") for c in cols[9:]]
    alts = alt.split(",") if alt else ["."]
    return VariantRecord(
        chrom=chrom,
        pos0=int(pos) - 1,
        ref=ref,
        alts=alts,
        qual=qual,
        filters=filters,
        fmt_keys=fmt_keys,
        sample_fields=sample_fields,
    )


def _read_tabix(path: str):
    """Parse a .tbi (gzip-compressed, BAI-like with sequence names).

    Returns (names, starts, linear): per-ref smallest data virtual offset
    (0 = none recorded) and the 16kb linear-index window voffs. None on
    an unreadable/foreign/truncated index (callers full-scan instead)."""
    import struct

    try:
        return _read_tabix_raw(path)
    except (struct.error, IndexError, ValueError, MemoryError,
            EOFError, OSError):
        return None


def _read_tabix_raw(path: str):
    import struct

    try:
        with gzip.open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if data[:4] != b"TBI\x01":
        return None
    pos = [4]

    def u32():
        v = struct.unpack_from("<i", data, pos[0])[0]
        pos[0] += 4
        return v

    def u64():
        v = struct.unpack_from("<Q", data, pos[0])[0]
        pos[0] += 8
        return v

    n_ref = u32()
    _fmt, _col_seq, _col_beg, _col_end, _meta, _skip = (
        u32(), u32(), u32(), u32(), u32(), u32())
    l_nm = u32()
    names = data[pos[0] : pos[0] + l_nm].split(b"\x00")[:-1]
    names = [n.decode() for n in names]
    pos[0] += l_nm
    starts = [0] * n_ref
    linear: list = [[] for _ in range(n_ref)]
    for r in range(n_ref):
        n_bin = u32()
        mn = 0
        for _ in range(n_bin):
            bin_ = u32()
            n_chunk = u32()
            for _ in range(n_chunk):
                beg = u64()
                u64()
                if bin_ != 37450 and (mn == 0 or beg < mn):
                    mn = beg
        n_intv = u32()
        for _ in range(n_intv):
            io_ = u64()
            linear[r].append(io_)
            if io_ and (mn == 0 or io_ < mn):
                mn = io_
        starts[r] = mn
    return names, starts, linear


@dataclass
class SnpTable:
    """Filtered, posterior-annotated SNP panel (device-ready)."""

    sample_ids: List[str]
    chroms: List[str]  # per-SNP chromosome name
    chrom_names: List[str]  # distinct chroms in order of appearance
    pos0: np.ndarray  # (nsnps,) int64, 0-based
    ref: np.ndarray  # (nsnps,) uint8 first REF char
    alt: np.ndarray  # (nsnps,) uint8 first ALT char
    af: np.ndarray  # (nsnps,) float64
    gps: np.ndarray  # (nsnps, nv, 3) float64 (post f32-dance)
    n_read: int = 0
    n_pass: int = 0

    @property
    def nsnps(self) -> int:
        return len(self.pos0)

    @property
    def nv(self) -> int:
        return len(self.sample_ids)


def resolve_samples(
    all_samples: List[str], sm_ids: Sequence[str], sm_list_path: str | None
) -> tuple[List[int], List[str]]:
    """Sample subsetting (bcf_filtered_reader.cpp:98-146).

    Specified IDs are collected into a sorted set (std::set) and resolved to
    column indices in *sorted-ID order*; without a subset, VCF column order.
    """
    ids = set(sm_ids or [])
    if sm_list_path:
        with open(sm_list_path) as fh:
            for line in fh:
                tok = line.split()
                if tok:
                    ids.add(tok[0])
    if ids:
        icols = []
        for sid in sorted(ids):
            if sid not in all_samples:
                error("Cannot find sample ID %s from the VCF file", sid)
            icols.append(all_samples.index(sid))
        return icols, [all_samples[i] for i in icols]
    return list(range(len(all_samples))), list(all_samples)


def load_snp_table(
    path: str,
    field_name: str = "GP",
    geno_error: float = 0.01,
    sm_ids: Sequence[str] = (),
    sm_list_path: str | None = None,
    min_mac: int = 1,
    min_callrate: float = 0.5,
    verbose: int = 10000,
    warn_non_biallelic: bool = True,
    regions=None,
) -> SnpTable:
    """Load + filter + convert a VCF into a SnpTable.

    Filter semantics mirror passed_vfilter (bcf_filtered_reader.cpp:498-574)
    with demuxlet's defaults: maxAlleles=2, require_GT (since minMAC/
    minCallRate > 0), callrate >= min_callrate, MAC >= min_mac.
    Posterior conversion per --field (GT/GP/PL), host/genotypes.py.

    regions: optional [(chrom, beg1, end0)] restriction (genome-sharded
    runs). With a .tbi-indexed .vcf.gz only the regions' file ranges are
    parsed (VcfReader.iter_regions); otherwise a full scan is
    post-filtered to the same SNP set (filter_snp_table semantics).
    """
    if path.endswith(".bcf"):
        from demuxlet_tpu_torch.io.bcf import BcfReader

        rdr: VcfReader | "BcfReader" = BcfReader(path)
    else:
        rdr = VcfReader(path)
    rec_iter = rdr
    post_filter = False
    if regions is not None:
        seeked = (rdr.iter_regions(regions)
                  if hasattr(rdr, "iter_regions") else None)
        if seeked is not None:
            rec_iter = seeked
            notice("VCF index seek: restricting parse to %d regions",
                   len(regions))
        else:
            post_filter = True
    icols, sel_ids = resolve_samples(rdr.samples, sm_ids, sm_list_path)
    notice("Finished identifying %d samples to load from VCF/BCF", len(icols))
    nsm = len(icols)

    chroms: List[str] = []
    chrom_names: List[str] = []
    seen_chroms = set()
    poss: List[int] = []
    refs: List[int] = []
    alts: List[int] = []
    afs: List[float] = []
    gps_list: List[np.ndarray] = []
    n_read = 0
    n_pass = 0
    n_non_biallelic = 0

    for rec in rec_iter:
        n_read += 1
        if verbose > 0 and n_read % verbose == 0:
            notice("Reading %d variants...", n_read)
        # --- passed_vfilter ---
        n_allele = len(rec.alts) + 1 if rec.alts != ["."] else 1
        if n_allele > 2:
            continue
        gt = rec.gt_pairs(icols)
        acs, an = G.count_alleles(gt)
        if min_callrate > an / (2.0 * nsm):
            continue
        ac = an - acs[0]
        if ac < min_mac or an - ac < min_mac:
            continue
        # --- parse posteriors ---
        if field_name == "GT":
            gps32 = G.gt_to_gps(gt, geno_error, acs, an)
        elif field_name == "PL":
            pls = rec.int_field("PL", icols, per=3)
            if pls is None:
                error(
                    "Cannot parse posterior probability at %s:%d",
                    rec.chrom,
                    rec.pos0 + 1,
                )
            gps32, acs, an = G.pl_to_gps(pls)
        else:
            raw = rec.float_field(field_name, icols, per=3)
            if raw is None:
                error(
                    "Cannot parse posterior probability at %s:%d",
                    rec.chrom,
                    rec.pos0 + 1,
                )
            gps32 = G.gp_to_gps(raw, geno_error)

        # --- non-SNP warning (still added; cmd_cram_demuxlet.cpp:215-225) ---
        if len(rec.ref) > 1 or n_allele != 2 or (rec.alts and len(rec.alts[0]) > 1):
            if warn_non_biallelic:
                if n_non_biallelic < 10:
                    warning(
                        "VCF record must be biallelic SNPs. Ignoring non-SNPs "
                        "and/or multi-allelic variants at %s:%d",
                        rec.chrom,
                        rec.pos0 + 1,
                    )
                elif n_non_biallelic == 10:
                    warning(
                        "Suppressing 10+ warnings of the same kind (non-SNP or "
                        "multi-alleic variants)"
                    )
            n_non_biallelic += 1

        if rec.chrom not in seen_chroms:
            seen_chroms.add(rec.chrom)
            chrom_names.append(rec.chrom)
        chroms.append(rec.chrom)
        poss.append(rec.pos0)
        refs.append(ord(rec.ref[0]))
        alt0 = rec.alts[0] if rec.alts else "."
        alts.append(ord(alt0[0]) if alt0 else ord("."))
        afs.append(G.compute_af(acs, an))
        gps_list.append(gps32.astype(np.float64))
        n_pass += 1

    rdr.close()
    notice("Finished reading %d markers from the VCF file", n_pass)
    if regions is not None and not post_filter and getattr(rdr, "contigs", None):
        # region-seeked parse: keep the FULL header contig list so region
        # chroms whose SNPs all fell outside the shard still resolve ids
        # for read-ownership accounting (mirrors filter_snp_table, which
        # keeps chrom_names intact for the same reason)
        chrom_names = list(rdr.contigs)
    table = SnpTable(
        sample_ids=sel_ids,
        chroms=chroms,
        chrom_names=chrom_names,
        pos0=np.asarray(poss, dtype=np.int64),
        ref=np.asarray(refs, dtype=np.uint8),
        alt=np.asarray(alts, dtype=np.uint8),
        af=np.asarray(afs, dtype=np.float64),
        gps=(
            np.stack(gps_list)
            if gps_list
            else np.zeros((0, nsm, 3), dtype=np.float64)
        ),
        n_read=n_read,
        n_pass=n_pass,
    )
    if post_filter:
        table = filter_snp_table(table, regions)
    return table


def expand_chr_pattern(pattern: str, chrom_names: Sequence[str]) -> List[str]:
    """Expand a -_CHR_- filename pattern into per-chromosome files.

    Reference analog: genomeChunk filename patterns (genomeChunk.h:8,
    genomeChunk.cpp:91-126) — there the chromosome list comes from a FASTA
    .fai; here it comes from the BAM header (always available to demuxlet).
    Missing files are skipped with a notice (bcf_chunked_reader.cpp:150-157).
    """
    return expand_chunk_pattern(
        pattern, [(c, 1) for c in chrom_names], unit=None
    )


def expand_chunk_pattern(
    pattern: str,
    chrom_lengths: Sequence[tuple],
    unit: Optional[int] = None,
) -> List[str]:
    """Expand -_CHR_- / -_BEG_- / -_END_- filename patterns into the
    per-interval file list, in genome order.

    Reference semantics (genomeChunk.cpp:3-126, setFileName :181-202):
    -_BEG_- and -_END_- must appear together or not at all; with them the
    genome is chunked into `unit`-bp intervals per chromosome and the
    placeholders substitute beg1/end0 of each interval; without them each
    chromosome is one interval (unit = INT_MAX). chrom_lengths: [(chrom,
    length)] from a FASTA .fai or the BAM header. Missing files are skipped
    with a notice (bcf_chunked_reader.cpp:150-157)."""
    import os

    beg_used = "-_BEG_-" in pattern
    end_used = "-_END_-" in pattern
    if beg_used != end_used:
        error(
            "Cannot parse %s because both -_BEG_- and -_END_- do not exist",
            pattern,
        )
    if beg_used and (unit is None or unit <= 0):
        error(
            "Pattern %s uses -_BEG_-/-_END_- but no positive --chunk-unit "
            "was given", pattern,
        )
    out = []
    for ch, ln in chrom_lengths:
        if beg_used:
            starts = range(1, max(ln, 1) + 1, unit)
        else:
            starts = [1]
        for beg1 in starts:
            end0 = min(beg1 + unit - 1, ln) if beg_used else ln
            f = (
                pattern.replace("-_CHR_-", ch)
                .replace("-_BEG_-", str(beg1))
                .replace("-_END_-", str(end0))
            )
            if os.path.exists(f):
                out.append(f)
            else:
                notice("Skipping missing chunk file %s", f)
    return out


def merge_snp_tables(tables: Sequence[SnpTable]) -> SnpTable:
    """Concatenate per-chunk SnpTables (same sample panel) in genome order."""
    if len(tables) == 1:
        return tables[0]
    base = tables[0]
    for t in tables[1:]:
        if t.sample_ids != base.sample_ids:
            error("chunked VCF files disagree on sample columns")
    chroms: List[str] = []
    chrom_names: List[str] = []
    seen = set()
    for t in tables:
        chroms.extend(t.chroms)
        for c in t.chrom_names:
            if c not in seen:
                seen.add(c)
                chrom_names.append(c)
    return SnpTable(
        sample_ids=base.sample_ids,
        chroms=chroms,
        chrom_names=chrom_names,
        pos0=np.concatenate([t.pos0 for t in tables]),
        ref=np.concatenate([t.ref for t in tables]),
        alt=np.concatenate([t.alt for t in tables]),
        af=np.concatenate([t.af for t in tables]),
        gps=np.concatenate([t.gps for t in tables])
        if sum(t.nsnps for t in tables)
        else base.gps,
        n_read=sum(t.n_read for t in tables),
        n_pass=sum(t.n_pass for t in tables),
    )


def filter_snp_table(table: SnpTable, regions) -> SnpTable:
    """Restrict a SnpTable to SNPs inside [(chrom, beg1, end0)] regions
    (genome-sharded ingest: LLK contributions then partition exactly by
    shard and sum across shards)."""
    import numpy as np

    keep = np.zeros(table.nsnps, dtype=bool)
    chrom_arr = np.asarray(table.chroms)
    for chrom, beg1, end0 in regions:
        keep |= (
            (chrom_arr == chrom)
            & (table.pos0 >= beg1 - 1)
            & (table.pos0 < end0)
        )
    idx = np.nonzero(keep)[0]
    chroms = [table.chroms[i] for i in idx]
    # chrom_names is VCF-order metadata (drives the BAM<->VCF order check);
    # keep it intact even for chromosomes whose SNPs were filtered away —
    # a shard whose region holds zero SNPs must still pass the check and
    # contribute an empty result to the distributed sum-gather.
    return SnpTable(
        sample_ids=table.sample_ids,
        chroms=chroms,
        chrom_names=table.chrom_names,
        pos0=table.pos0[idx],
        ref=table.ref[idx],
        alt=table.alt[idx],
        af=table.af[idx],
        gps=table.gps[idx] if len(idx) else table.gps[:0],
        n_read=table.n_read,
        n_pass=table.n_pass,
    )
