"""Pileup -> device "slot" representation.

Each barcode's covered SNPs become a padded row of slots; per slot a dense
(allele, BQ)-binned UMI count vector. This is the sparse->dense bridge
(SURVEY.md §7 'Sparse→dense blowup'): empty (cell, SNP) pairs never reach the
device, and the slot axis is padded to a lane-friendly multiple.

Slot tensors for a block of B cells with at most S_max covered SNPs each:
  idx[B, S_max]  int32  SNP ids (0-padded)
  msk[B, S_max]  bool   slot validity
  cnt[B, S_max, NB] int32 counts, NB = 2*(cap_bq+1)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from demuxlet_tpu_torch.host.pileup import PileupData


def _round_up(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclass
class SlotBlock:
    cell_ids: np.ndarray  # (B,) int32 cell ids in pileup numbering
    idx: np.ndarray  # (B, S_max) int32
    msk: np.ndarray  # (B, S_max) bool
    cnt: np.ndarray  # (B, S_max, NB) int32

    @property
    def n_cells(self) -> int:
        return len(self.cell_ids)


def build_slots(
    scl,
    cell_ids: Sequence[int],
    cap_bq: int = 40,
    pad_slots_to: int = 8,
) -> SlotBlock:
    """Slot tensors for the given cells (typically one barcode block).

    Accepts either the dict-based PileupData or the CSR pileup (native
    ingest); the CSR path is vectorized."""
    if hasattr(scl, "cell_ptr"):
        from demuxlet_tpu_torch.host.csr import build_slots_csr

        return build_slots_csr(scl, cell_ids, cap_bq, pad_slots_to)
    nq = cap_bq + 1
    nb = 2 * nq
    per_cell: List[List[int]] = [scl.cell_snps(c) for c in cell_ids]
    smax = _round_up(max((len(s) for s in per_cell), default=1), pad_slots_to)
    B = len(cell_ids)
    idx = np.zeros((B, smax), dtype=np.int32)
    msk = np.zeros((B, smax), dtype=bool)
    cnt = np.zeros((B, smax, nb), dtype=np.int32)
    for r, c in enumerate(cell_ids):
        for j, s in enumerate(per_cell[r]):
            idx[r, j] = s
            msk[r, j] = True
            for al, bq in scl.umis[(s, c)].values():
                if al == 2:
                    continue  # skipped by all likelihood loops
                cnt[r, j, al * nq + min(bq, cap_bq)] += 1
    return SlotBlock(
        cell_ids=np.asarray(list(cell_ids), dtype=np.int32),
        idx=idx,
        msk=msk,
        cnt=cnt,
    )
