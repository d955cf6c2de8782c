"""Phred-score conversion tables.

Reproduces the lookup tables of the reference implementation
(reference: PhredHelper.cpp:24-40), including the quirk that Phred 0 and 1
are both treated as 75% error (PhredHelper.cpp:30).

All tables are float64 NumPy arrays of length 256 so that device kernels and
the NumPy oracle share bit-identical constants.
"""

from __future__ import annotations

import numpy as np

# NOTE: CPython's float ** matches glibc pow() bit-for-bit; np.power does
# NOT (11/256 entries differ by 1 ulp) — so build via Python pow.
_POW = np.array([0.1 ** (i * 0.1) for i in range(256)], dtype=np.float64)

# phred2Err[i] = 10^(-i/10) for i > 1, else 0.75   (PhredHelper.cpp:30)
PHRED2ERR = _POW.copy()
PHRED2ERR[0] = 0.75
PHRED2ERR[1] = 0.75

# phred2Prob[i] = 10^(-i/10) with no special-casing  (PhredHelper.cpp:31)
PHRED2PROB = _POW.copy()

# phred2Mat[i] = 1 - phred2Err[i]                    (PhredHelper.cpp:32)
PHRED2MAT = 1.0 - PHRED2ERR


def to_prob(phred: np.ndarray | int) -> np.ndarray | float:
    """P(error) for a Phred value with the reference's uint32 clamp.

    Reference: PhredHelper.h:40 — the argument is a *uint32*, so negative
    int32 inputs (htslib missing/vector-end sentinels) wrap to huge values
    and clamp to phred2Prob[255]. We replicate by clamping anything outside
    [0, 255] to 255 after reinterpreting negatives as large-unsigned.
    """
    p = np.asarray(phred)
    # int32 -> uint32 reinterpretation: negatives become > 255
    wrapped = np.where(p < 0, np.int64(256), p.astype(np.int64))
    idx = np.minimum(wrapped, 255)
    out = PHRED2PROB[idx]
    return out if out.ndim else float(out)
