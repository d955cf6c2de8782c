"""Genotype-field -> posterior-probability conversion.

Replicates the reference's parse_posteriors math exactly, including its
float32 intermediates (reference: bcf_filtered_reader.cpp:360-454 for GT/GP,
:244-320 for the PL EM; gps is `float*` per bcf_filtered_reader.h:78, and the
caller copies to float64 at cmd_cram_demuxlet.cpp:181-183).

All functions operate on biallelic diploid records (ngenos == 3), which is
all demuxlet ever feeds them (vfilt.maxAlleles == 2, ploidies all 2).

Genotype encoding for `gt`: -1 = missing, 0 = RR, 1 = RA, 2 = AA
(bcf_alleles2gt of the two allele indices).
"""

from __future__ import annotations

import numpy as np

from demuxlet_tpu_torch.utils.phred import to_prob

F32 = np.float32
F64 = np.float64


def count_alleles(gt_pairs: np.ndarray) -> tuple[np.ndarray, int]:
    """Allele counts over selected samples (parse_genotypes, :233-240 region).

    gt_pairs: (nsm, 2) int array of allele indices, -1 for missing.
    Returns (acs[2] float64, an int): each non-missing allele call counts 1.
    """
    acs = np.zeros(2, dtype=F64)
    an = 0
    for a in gt_pairs.reshape(-1):
        if a >= 0:
            an += 1
            acs[a] += 1.0
    return acs, an


def genotype_code(gt_pairs: np.ndarray) -> np.ndarray:
    """bcf_alleles2gt per sample; -1 if either allele missing
    (bcf_filtered_reader.h:144-149)."""
    a1 = gt_pairs[:, 0]
    a2 = gt_pairs[:, 1]
    lo = np.minimum(a1, a2)
    hi = np.maximum(a1, a2)
    g = hi * (hi + 1) // 2 + lo
    return np.where((a1 < 0) | (a2 < 0), -1, g)


def gt_to_gps(
    gt_pairs: np.ndarray, gt_error: float, acs: np.ndarray, an: int
) -> np.ndarray:
    """--field GT path (bcf_filtered_reader.cpp:368-406).

    Called genotype g gets 1-gt_error, others gt_error/2; missing genotypes
    get HWE probabilities from pseudocounted allele frequencies
    (acs[j]+1/2)/(an+1). Stored as float32 (the reference's gps buffer).
    Returns (nsm, 3) float32.
    """
    nsm = gt_pairs.shape[0]
    g = genotype_code(gt_pairs)
    out = np.empty((nsm, 3), dtype=F32)
    # HWE pseudo-frequencies (computed in double, stored to float)
    p0 = (acs[0] + 1.0 / 2.0) / (an + 1.0)
    p1 = (acs[1] + 1.0 / 2.0) / (an + 1.0)
    # entry order/assoc as the C expression ((j==k?1:2) * pj) * pk, genotype
    # order (0,0),(1,0),(1,1)
    hwe = np.array([(1.0 * p0) * p0, (2.0 * p1) * p0, (1.0 * p1) * p1], dtype=F64)
    for i in range(nsm):
        if g[i] < 0:
            out[i] = hwe.astype(F32)
        else:
            for j in range(3):
                out[i, j] = F32(
                    (1.0 - gt_error) if g[i] == j else gt_error / 2.0
                )
    return out


def gp_to_gps(raw_gp: np.ndarray, gt_error: float) -> np.ndarray:
    """--field GP path (bcf_filtered_reader.cpp:410-453).

    raw_gp: (nsm, 3) float32 of the selected samples' GP values.
    Per-sample renormalize (float32 accumulation); gpSums = mean over samples
    plus a uniform-HWE pseudo-sample [0.25, 0.5, 0.25]; blend
    gp = (1-gt_error)*gp + gt_error*gpSums (double arithmetic, float32 store).
    Returns (nsm, 3) float32.
    """
    nsm = raw_gp.shape[0]
    gps = raw_gp.astype(F32).copy()
    gp_sums = np.array([1.0 / 4.0, 2.0 / 4.0, 1.0 / 4.0], dtype=F32)
    for i in range(nsm):
        s = F32(0.0)
        for j in range(3):
            s = F32(s + gps[i, j])
        for j in range(3):
            gps[i, j] = F32(gps[i, j] / s)
            gp_sums[j] = F32(gp_sums[j] + gps[i, j])
    denom = np.int32(nsm + 1.0)  # (int32_t)(sm_icols.size()+1.0) at :441
    for j in range(3):
        gp_sums[j] = F32(gp_sums[j] / denom)
    for i in range(nsm):
        for j in range(3):
            gps[i, j] = F32(
                (1.0 - gt_error) * F64(gps[i, j]) + gt_error * F64(gp_sums[j])
            )
    return gps


def pl_to_gps(pls: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """--field PL path (bcf_filtered_reader.cpp:244-320).

    pls: (nsm, 3) int32 Phred-scaled likelihoods (negative = missing sentinel,
    which the reference's uint32 cast clamps to Phred 255).
    10-iteration EM for allele frequency starting at 1/2; posterior
    ∝ HWE(af) * 10^(-PL/10). Returns (gps (nsm,3) float32, acs, an) where
    acs = final_af * an (the reference scales acs by an at :317-318).
    """
    nsm = pls.shape[0]
    niter = 10
    acs = np.array([0.5, 0.5], dtype=F64)  # initial allele frequencies
    probs = np.array(
        [[to_prob(int(pls[i, l])) for l in range(3)] for i in range(nsm)],
        dtype=F64,
    )
    gps = np.empty((nsm, 3), dtype=F32)
    an = 0
    for it in range(niter):
        newacs = np.zeros(2, dtype=F64)
        an = 0
        for i in range(nsm):
            # genotype order l=0:(0,0), l=1:(1,0), l=2:(1,1)
            # coefficient assoc as C: ((j==k?1:2) * acs[j]) * acs[k]
            gp = np.empty(3, dtype=F64)
            gp[0] = (1.0 * acs[0]) * acs[0] * probs[i, 0]
            gp[1] = (2.0 * acs[1]) * acs[0] * probs[i, 1]
            gp[2] = (1.0 * acs[1]) * acs[1] * probs[i, 2]
            sumgp = (gp[0] + gp[1]) + gp[2]
            gp /= sumgp
            # accumulation order as the reference's l-loop (:276-283):
            # l=0: newacs[0]+=gp0 twice; l=1: newacs[1]+=gp1, newacs[0]+=gp1;
            # l=2: newacs[1]+=gp2 twice
            newacs[0] += gp[0]
            newacs[0] += gp[0]
            newacs[1] += gp[1]
            newacs[0] += gp[1]
            newacs[1] += gp[2]
            newacs[1] += gp[2]
            an += 2
            if it + 1 == niter:
                gps[i] = gp.astype(F32)
        acs = newacs / an
    acs = acs * an
    return gps, acs, an


def compute_af(acs: np.ndarray, an: int) -> float:
    """get_af(1) = (acs[1]+0.5)/(an+1) (bcf_filtered_reader.h:177-179)."""
    return (acs[1] + 1.0 / len(acs)) / (an + 1.0)
