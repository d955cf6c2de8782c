"""CSR pileup: cell-major observation arrays for production-scale ingest.

The dict-based PileupData (host/pileup.py) mirrors the reference's
std::map-of-maps (sc_drop_seq.h:21-58) and is convenient for small inputs and
oracle tests; this CSR form is what the native C++ ingest emits and what the
vectorized slot builder consumes at 100K-barcode scale: one row per unique
(snp, cell, UMI) observation, sorted by (cell, snp).

Slots with only allele==2 (mismatch-both) observations are kept in the slot
mask with zero counts — the reference includes such SNPs in a cell's covered
set and they contribute a uniform-GL term to every sample's LLK
(cmd_cram_demuxlet.cpp:426-459 with the :435 skip).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np


@dataclass
class CsrPileup:
    sample_ids: List[str]
    nsnps: int
    barcodes: List[str]
    cell_totl: np.ndarray  # (ncells,) int64
    cell_pass: np.ndarray
    cell_uniq: np.ndarray
    cell_ptr: np.ndarray  # (ncells+1,) int64 into obs arrays
    obs_snp: np.ndarray  # (nobs,) int32, sorted within each cell
    obs_allele: np.ndarray  # (nobs,) uint8
    obs_bq: np.ndarray  # (nobs,) uint8

    @property
    def nbcs(self) -> int:
        return len(self.barcodes)

    @property
    def nv(self) -> int:
        return len(self.sample_ids)

    def cell_snps(self, cellid: int) -> np.ndarray:
        a, b = self.cell_ptr[cellid], self.cell_ptr[cellid + 1]
        return np.unique(self.obs_snp[a:b])

    def n_cell_snps(self, cellid: int) -> int:
        return len(self.cell_snps(cellid))

    def n_snps_all(self) -> np.ndarray:
        """(ncells,) distinct-SNP counts, vectorized over all cells (obs
        are (cell, snp)-sorted, so distinct slots = run starts; the
        per-cell np.unique loop this replaced dominated the output phase
        at 100K cells). MEMOIZED: the engine's coverage-sorted blocking
        and cell_stats both need it, and each pass re-walks the multi-GB
        obs arrays (20-43 s at 100K cells on this host). Obs arrays are
        append-free after construction; the cache is additionally keyed
        on len(obs_snp) as a cheap staleness check."""
        cached = getattr(self, "_nsnp_cache", None)
        if cached is not None and cached[0] == len(self.obs_snp):
            return cached[1]
        out = self._n_snps_all_impl()
        self._nsnp_cache = (len(self.obs_snp), out)
        return out

    def obs_pass(self, cap_bq: int) -> bool:
        """One native pass over every observation (native/obs.py) that
        fills both caches of the engine's set-up: n_snps_all's and the
        wire code histogram of ``code_hist(cap_bq)``. False, with neither
        filled, where the native library is absent or refuses the input;
        the numpy passes then run as before."""
        from demuxlet_tpu_torch.native import obs

        got = obs.obs_pass(self, cap_bq)
        if got is None:
            return False
        n = len(self.obs_snp)
        self._nsnp_cache = (n, got[0])
        self._code_hist_cache = (cap_bq, n, got[1])
        return True

    def code_hist(self, cap_bq: int):
        """The code histogram ``obs_pass(cap_bq)`` cached (the counts of
        host/wire.choose_cfg's code pass), or None."""
        cached = getattr(self, "_code_hist_cache", None)
        if cached is not None and cached[:2] == (cap_bq, len(self.obs_snp)):
            return cached[2]
        return None

    def _n_snps_all_impl(self) -> np.ndarray:
        n = self.nbcs
        tot = len(self.obs_snp)
        if tot == 0:
            return np.zeros(n, dtype=np.int64)
        lengths = np.diff(self.cell_ptr)
        new_slot = np.empty(tot, dtype=bool)
        new_slot[0] = True
        np.not_equal(self.obs_snp[1:], self.obs_snp[:-1], out=new_slot[1:])
        starts = self.cell_ptr[:-1][lengths > 0]
        new_slot[starts] = True
        # per-cell sums of new_slot via one cumsum + ptr-range differences
        # (~1.7x faster than repeat(row ids) + bincount at 200M obs)
        cs = np.cumsum(new_slot)
        ptr = self.cell_ptr
        lo = np.where(ptr[:-1] > 0, cs[np.maximum(ptr[:-1], 1) - 1], 0)
        hi = np.where(ptr[1:] > 0, cs[np.maximum(ptr[1:], 1) - 1], 0)
        return (hi - lo).astype(np.int64)

    @staticmethod
    def from_arrays(
        sample_ids: List[str],
        nsnps: int,
        barcodes: List[str],
        totl: np.ndarray,
        pass_: np.ndarray,
        uniq: np.ndarray,
        obs_cell: np.ndarray,
        obs_snp: np.ndarray,
        obs_allele: np.ndarray,
        obs_bq: np.ndarray,
    ) -> "CsrPileup":
        """Sort COO observations by (cell, snp) and build the CSR index."""
        order = np.lexsort((obs_snp, obs_cell))
        obs_cell = obs_cell[order]
        obs_snp = obs_snp[order]
        obs_allele = obs_allele[order]
        obs_bq = obs_bq[order]
        n = len(barcodes)
        cell_ptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(cell_ptr, obs_cell + 1, 1)
        np.cumsum(cell_ptr, out=cell_ptr)
        return CsrPileup(
            sample_ids=sample_ids,
            nsnps=nsnps,
            barcodes=barcodes,
            cell_totl=np.asarray(totl, dtype=np.int64),
            cell_pass=np.asarray(pass_, dtype=np.int64),
            cell_uniq=np.asarray(uniq, dtype=np.int64),
            cell_ptr=cell_ptr,
            obs_snp=obs_snp.astype(np.int32),
            obs_allele=obs_allele.astype(np.uint8),
            obs_bq=obs_bq.astype(np.uint8),
        )

    @staticmethod
    def from_pileup(scl) -> "CsrPileup":
        """Convert a dict-based PileupData (for tests / the Python path)."""
        cells, snps, alleles, bqs = [], [], [], []
        for (s, c), d in scl.umis.items():
            for al, bq in d.values():
                cells.append(c)
                snps.append(s)
                alleles.append(al)
                bqs.append(bq)
        return CsrPileup.from_arrays(
            scl.sample_ids,
            scl.nsnps,
            list(scl.barcodes),
            np.asarray(scl.cell_totl),
            np.asarray(scl.cell_pass),
            np.asarray(scl.cell_uniq),
            np.asarray(cells, dtype=np.int64),
            np.asarray(snps, dtype=np.int64),
            np.asarray(alleles, dtype=np.int64),
            np.asarray(bqs, dtype=np.int64),
        )


def build_codes_block(
    csr: CsrPileup,
    cell_ids: Sequence[int],
    cap_bq: int = 40,
    pad_slots_to: int = 128,
    pad_cells_to: int = 32,
):
    """Compact per-UMI observation codes for the device fast path.

    Returns (codes, idx, msk):
      codes (Bp, Sp, U) uint8 — code = allele * (cap_bq+1) + min(bq, cap_bq)
            for each unique UMI of the slot; NONE (=255) padding. allele==2
            observations are dropped (skipped by all likelihood loops).
      idx   (Bp, Sp) int32 SNP ids (0-padded)
      msk   (Bp, Sp) bool slot validity
    U is the block's max per-slot UMI count bucketed to a power of two; Bp/Sp
    are padded to pad_cells_to / pad_slots_to.

    Fully vectorized over the block (obs are (cell, snp)-sorted in the CSR):
    the per-cell Python loop this replaces dominated end-to-end wall clock
    at 100K cells (~4.6 ms/cell host vs ~6 us/cell device).
    """
    nq = cap_bq + 1
    B = len(cell_ids)
    ci = np.asarray(cell_ids, dtype=np.int64)
    a = csr.cell_ptr[ci]
    b = csr.cell_ptr[ci + 1]
    lengths = (b - a).astype(np.int64)
    tot = int(lengths.sum())

    # kernel tile requirements: slots %% 128, cells %% 32 (pallas_pair.TB/TS)
    pad_slots_to = max(pad_slots_to, 128)
    pad_cells_to = max(pad_cells_to, 32)
    if pad_cells_to % 32:
        pad_cells_to = -(-pad_cells_to // 32) * 32

    if tot == 0:
        Sp = pad_slots_to
        Bp = max(pad_cells_to, -(-B // pad_cells_to) * pad_cells_to)
        return (
            np.full((Bp, Sp, 1), 255, dtype=np.uint8),
            np.zeros((Bp, Sp), dtype=np.int32),
            np.zeros((Bp, Sp), dtype=bool),
        )

    pos = np.arange(tot, dtype=np.int32)
    row_of = np.repeat(np.arange(B, dtype=np.int32), lengths)
    ends = np.cumsum(lengths)
    cell_first = (ends - lengths).astype(np.int32)  # block-local starts
    if (a[1:] == b[:-1]).all():
        # contiguous cell range: the obs are one slice (no gather)
        lo, hi = int(a[0]), int(b[-1])
        snp = csr.obs_snp[lo:hi]
        al = csr.obs_allele[lo:hi]
        bq = np.minimum(csr.obs_bq[lo:hi], cap_bq)
    else:
        obs_pos = pos + np.repeat(a - cell_first, lengths)
        snp = csr.obs_snp[obs_pos]
        al = csr.obs_allele[obs_pos]
        bq = np.minimum(csr.obs_bq[obs_pos], cap_bq)

    # slot boundaries: first obs of a cell, or a snp change within the cell
    new_slot = np.empty(tot, dtype=bool)
    new_slot[0] = True
    np.not_equal(snp[1:], snp[:-1], out=new_slot[1:])
    new_slot[cell_first[lengths > 0]] = True
    slot_global = np.cumsum(new_slot, dtype=np.int32)
    slot_global -= 1
    slot_of_start = np.flatnonzero(new_slot).astype(np.int32)
    # per-cell local slot index: gather per obs via row_of (repeat with
    # ragged sizes is ~10x slower than a fancy gather here)
    nzmask = lengths > 0
    cell_base = np.zeros(B, dtype=np.int32)
    cell_base[nzmask] = slot_global[cell_first[nzmask]]
    slot_local = slot_global - cell_base[row_of]
    # umi index within slot
    occ = pos - slot_of_start[slot_global]

    n_slots_per_cell = np.zeros(B, dtype=np.int64)
    n_slots_per_cell[nzmask] = slot_local[ends[nzmask] - 1] + 1
    smax = int(n_slots_per_cell.max())
    umax = int(occ.max()) + 1

    Sp = max(pad_slots_to, -(-smax // pad_slots_to) * pad_slots_to)
    Bp = max(pad_cells_to, -(-B // pad_cells_to) * pad_cells_to)
    U = 1
    while U < umax:
        U *= 2

    codes = np.full((Bp, Sp, U), 255, dtype=np.uint8)
    idx = np.zeros((Bp, Sp), dtype=np.int32)
    msk = np.zeros((Bp, Sp), dtype=bool)
    flat2 = row_of[slot_of_start] * np.int32(Sp) + slot_local[slot_of_start]
    idx.ravel()[flat2] = snp[slot_of_start]
    msk.ravel()[flat2] = True
    sel = np.flatnonzero(al < 2)
    flat3 = (row_of[sel] * np.int32(Sp) + slot_local[sel]) * np.int32(
        U
    ) + occ[sel]
    codes.ravel()[flat3] = (
        al[sel].astype(np.uint16) * nq + bq[sel]
    ).astype(np.uint8)
    return codes, idx, msk


def build_slots_csr(csr: CsrPileup, cell_ids: Sequence[int], cap_bq: int = 40,
                    pad_slots_to: int = 8):
    """Vectorized SlotBlock construction from CSR observations."""
    from demuxlet_tpu_torch.host.slots import SlotBlock, _round_up

    nq = cap_bq + 1
    nb = 2 * nq
    B = len(cell_ids)
    per_cell = []
    smax = 1
    for c in cell_ids:
        a, b = csr.cell_ptr[c], csr.cell_ptr[c + 1]
        snps, inv = np.unique(csr.obs_snp[a:b], return_inverse=True)
        per_cell.append((a, b, snps, inv))
        smax = max(smax, len(snps))
    smax = _round_up(smax, pad_slots_to)
    idx = np.zeros((B, smax), dtype=np.int32)
    msk = np.zeros((B, smax), dtype=bool)
    cnt = np.zeros((B, smax, nb), dtype=np.int32)
    for r, (a, b, snps, inv) in enumerate(per_cell):
        k = len(snps)
        idx[r, :k] = snps
        msk[r, :k] = True
        al = csr.obs_allele[a:b]
        sel = al < 2
        bins = al[sel].astype(np.int64) * nq + np.minimum(
            csr.obs_bq[a:b][sel], cap_bq
        )
        np.add.at(cnt[r], (inv[sel], bins), 1)
    return SlotBlock(
        cell_ids=np.asarray(list(cell_ids), dtype=np.int32),
        idx=idx,
        msk=msk,
        cnt=cnt,
    )
