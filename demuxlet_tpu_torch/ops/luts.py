"""Device lookup tables derived from the Phred tables and the alpha grid.

The TPU reformulation (SURVEY.md §7): both likelihood recursions telescope,
so per-(cell,SNP) raw likelihoods are linear in the (allele, BQ) observation
counts in log space:

  pass 1:  log GLraw[g]      = sum_{a,q} C[a,q] * LOGF[(a,q), g]
  pass 2:  log pGraw[k,l,m]  = sum_{a,q} C[a,q] * W[(a,q), (k,l,m)]

with LOGF/W tiny dense LUTs — turning the reference's per-UMI scalar loops
(cmd_cram_demuxlet.cpp:428-443, :600-640) into MXU matmuls.

Observation index nb = a * n_q + q, a in {0,1} (allele-2 observations are
dropped upstream), q in [0, cap_bq].
"""

from __future__ import annotations

import numpy as np

from demuxlet_tpu_torch.utils.phred import PHRED2ERR, PHRED2MAT


def n_obs_bins(cap_bq: int = 40) -> int:
    return 2 * (cap_bq + 1)


def singlet_lut(cap_bq: int = 40) -> np.ndarray:
    """LOGF[(a,q), g]: log of the per-UMI GL factor (cmd_cram_demuxlet.cpp
    :437-439).

      g=0: a==0 ? 1-e : e/3      g=1: 0.5 - e/3      g=2: a==1 ? 1-e : e/3
    """
    nq = cap_bq + 1
    out = np.empty((2 * nq, 3), dtype=np.float64)
    for a in (0, 1):
        for q in range(nq):
            e3 = PHRED2ERR[q] / 3.0
            f0 = PHRED2MAT[q] if a == 0 else e3
            f1 = 0.5 - e3
            f2 = PHRED2MAT[q] if a == 1 else e3
            out[a * nq + q] = np.log([f0, f1, f2])
    return out


def pair_lut(grid_alpha, cap_bq: int = 40) -> np.ndarray:
    """W[(a,q), (k,l,m)]: log of the per-UMI mixture factor
    (cmd_cram_demuxlet.cpp:606-625): pR*(1-p) + pA*p with
    p = 0.5*l + (m-l)*0.5*alpha_k.
    Output shape (2*(cap_bq+1), nA*9), flattened k*9 + l*3 + m.
    """
    nq = cap_bq + 1
    na = len(grid_alpha)
    out = np.empty((2 * nq, na * 9), dtype=np.float64)
    for a in (0, 1):
        for q in range(nq):
            e3 = PHRED2ERR[q] / 3.0
            pr = PHRED2MAT[q] if a == 0 else e3
            pa = PHRED2MAT[q] if a == 1 else e3
            row = np.empty(na * 9, dtype=np.float64)
            for k, alpha in enumerate(grid_alpha):
                for l in range(3):
                    for m in range(3):
                        p = 0.5 * l + (m - l) * 0.5 * alpha
                        row[k * 9 + l * 3 + m] = pr * (1.0 - p) + pa * p
            out[a * nq + q] = np.log(row)
    return out


def singlet_prob_lut(cap_bq: int = 40) -> np.ndarray:
    """Probability-domain LOGF (no log): the per-UMI GL factors themselves.
    Used by the df32 exact path, which multiplies probabilities directly
    with exponent tracking — the reference's own arithmetic
    (cmd_cram_demuxlet.cpp:437-443) — instead of exp(sum of logs)."""
    return np.exp(singlet_lut(cap_bq))


def pair_prob_lut(grid_alpha, cap_bq: int = 40) -> np.ndarray:
    """Probability-domain W (no log): per-UMI mixture factors
    pR*(1-p) + pA*p (cmd_cram_demuxlet.cpp:606-625), exact f64 values."""
    nq = cap_bq + 1
    na = len(grid_alpha)
    out = np.empty((2 * nq, na * 9), dtype=np.float64)
    for a in (0, 1):
        for q in range(nq):
            e3 = PHRED2ERR[q] / 3.0
            pr = PHRED2MAT[q] if a == 0 else e3
            pa = PHRED2MAT[q] if a == 1 else e3
            for k, alpha in enumerate(grid_alpha):
                for l in range(3):
                    for m in range(3):
                        p = 0.5 * l + (m - l) * 0.5 * alpha
                        out[a * nq + q, k * 9 + l * 3 + m] = (
                            pr * (1.0 - p) + pa * p
                        )
    return out
