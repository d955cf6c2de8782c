"""Reference-faithful NumPy/Python oracle for the demuxlet likelihood passes.

This is a deliberately *slow, loop-faithful* re-implementation of the two
likelihood passes and output writing of the reference
(cmd_cram_demuxlet.cpp:390-875), used as the ground truth that the TPU engine
must match at printed precision. It follows the reference's exact evaluation
order: per-UMI renormalization (":440-443"), 1e-6 smoothing (":446-452"),
per-UMI max-renormalization in the pair pass (":626-639"), strict-inequality
running argmaxes, and the -1e300-seeded sequential log-sum-exp (":476-501").

It operates on an in-memory pileup ("PileupData") that mirrors
sc_dropseq_lib_t (sc_drop_seq.h:21-58): std::map iteration orders are
reproduced by sorting keys (barcodes lexicographically via byte order, UMIs
lexicographically, cell/snp ids numerically).
"""

from __future__ import annotations

import math

import numpy as np

from demuxlet_tpu_torch.host.pileup import PileupData  # shared data model
from demuxlet_tpu_torch.utils.phred import PHRED2ERR, PHRED2MAT

__all__ = [
    "PileupData",
    "compute_gp0s",
    "pass1_singlet",
    "write_single",
    "pass2_cell",
    "pass2_outputs",
]


def compute_gp0s(scl: PileupData) -> np.ndarray:
    """Mean genotype posterior per SNP (cmd_cram_demuxlet.cpp:390-401)."""
    gp0s = np.zeros((scl.nsnps, 3), dtype=np.float64)
    for i in range(scl.nsnps):
        g = scl.snp_gps[i]  # (nv, 3)
        for j in range(scl.nv):
            gp0s[i, 0] += g[j, 0]
            gp0s[i, 1] += g[j, 1]
            gp0s[i, 2] += g[j, 2]
        gp0s[i] /= scl.nv
    return gp0s


def pass1_singlet(scl: PileupData, gp0s: np.ndarray):
    """Pass 1 (cmd_cram_demuxlet.cpp:415-461): per-(cell,sample) LLKs.

    Returns (llks[nbcs, nv], llk0s[nbcs]).
    """
    nv = scl.nv
    llks = np.zeros((scl.nbcs, nv), dtype=np.float64)
    llk0s = np.zeros(scl.nbcs, dtype=np.float64)
    for i in range(scl.nsnps):
        for c in scl.snp_cells(i):
            GL = [1.0, 1.0, 1.0]
            for al, bq in scl.sorted_umis(i, c):
                if al == 2:
                    continue
                e3 = PHRED2ERR[bq] / 3.0
                GL[0] *= PHRED2MAT[bq] if al == 0 else e3
                GL[1] *= 0.5 - e3
                GL[2] *= PHRED2MAT[bq] if al == 1 else e3
                t = GL[0] + GL[1] + GL[2]
                GL[0] /= t
                GL[1] /= t
                GL[2] /= t
            GL[0] += 1e-6
            GL[1] += 1e-6
            GL[2] += 1e-6
            t = GL[0] + GL[1] + GL[2]
            GL[0] /= t
            GL[1] /= t
            GL[2] /= t
            gps = scl.snp_gps[i]
            for k in range(nv):
                llks[c, k] += math.log(
                    GL[0] * gps[k, 0] + GL[1] * gps[k, 1] + GL[2] * gps[k, 2]
                )
            llk0s[c] += math.log(
                GL[0] * gp0s[i, 0] + GL[1] * gp0s[i, 1] + GL[2] * gp0s[i, 2]
            )
    return llks, llk0s


def write_single(scl: PileupData, llks, llk0s, min_total=0, min_uniq=0, min_snp=0):
    """The .single file body (cmd_cram_demuxlet.cpp:470-517). Returns lines."""
    nv = scl.nv
    lines = ["BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\tPOSTPRB"]
    for bc, c in scl.bc_order():
        if (
            scl.cell_totl[c] < min_total
            or scl.cell_uniq[c] < min_uniq
            or scl.n_cell_snps(c) < min_snp
        ):
            continue
        sumLLK = -1e300
        for j in range(nv):
            cur = llks[c, j]
            if sumLLK > cur:
                sumLLK = sumLLK + math.log(1.0 + math.exp(cur - sumLLK))
            else:
                sumLLK = cur + math.log(1.0 + math.exp(sumLLK - cur))
        for j in range(nv):
            cur = llks[c, j]
            lines.append(
                "%s\t%s\t%d\t%d\t%d\t%d\t%.5f\t%.5f\t%.3g"
                % (
                    bc,
                    scl.sample_ids[j],
                    scl.cell_totl[c],
                    scl.cell_pass[c],
                    scl.cell_uniq[c],
                    scl.n_cell_snps(c),
                    cur,
                    llk0s[c],
                    math.exp(cur - sumLLK),
                )
            )
    return lines


def pass2_cell(scl: PileupData, gp0s, cellid: int, grid_alpha):
    """Pair-search LLK accumulation for one cell (cmd_cram_demuxlet.cpp:595-709).

    Returns (llksAB[nv, nv, nA], llksA0[nv, nA], llks00[nA]).
    """
    nv = scl.nv
    nA = len(grid_alpha)
    llksAB = np.zeros((nv, nv, nA), dtype=np.float64)
    llksA0 = np.zeros((nv, nA), dtype=np.float64)
    llks00 = np.zeros(nA, dtype=np.float64)
    for isnp in scl.cell_snps(cellid):
        pGs = np.ones(nA * 9, dtype=np.float64)
        for al, bq in scl.sorted_umis(isnp, cellid):
            if al == 2:
                continue
            e3 = PHRED2ERR[bq] / 3.0
            pR = PHRED2MAT[bq] if al == 0 else e3
            pA = PHRED2MAT[bq] if al == 1 else e3
            maxpG = 0.0
            for k in range(nA):
                for l in range(3):
                    for m in range(3):
                        p = 0.5 * l + (m - l) * 0.5 * grid_alpha[k]
                        pGs[k * 9 + l * 3 + m] *= pR * (1.0 - p) + pA * p
                        if maxpG < pGs[k * 9 + l * 3 + m]:
                            maxpG = pGs[k * 9 + l * 3 + m]
            pGs /= maxpG
        pGs += 1e-6
        pGs /= pGs.max()  # reference takes max after +=1e-6 (:643-663)

        gps = scl.snp_gps[isnp]  # (nv, 3)
        for j in range(nv):
            for k in range(nv):
                sumPs = np.zeros(nA, dtype=np.float64)
                for l in range(3):
                    for m in range(3):
                        p = gps[j, l] * gps[k, m]
                        for n in range(nA):
                            sumPs[n] += p * pGs[n * 9 + l * 3 + m]
                for n in range(nA):
                    llksAB[j, k, n] += math.log(sumPs[n])
            sumPs = np.zeros(nA, dtype=np.float64)
            for l in range(3):
                for m in range(3):
                    p = gps[j, l] * gp0s[isnp, m]
                    for n in range(nA):
                        sumPs[n] += p * pGs[n * 9 + l * 3 + m]
            for n in range(nA):
                llksA0[j, n] += math.log(sumPs[n])
        sumPs = np.zeros(nA, dtype=np.float64)
        for l in range(3):
            for m in range(3):
                p = gp0s[isnp, l] * gp0s[isnp, m]
                for n in range(nA):
                    sumPs[n] += p * pGs[n * 9 + l * 3 + m]
        for n in range(nA):
            llks00[n] += math.log(sumPs[n])
    return llksAB, llksA0, llks00


def pass2_outputs(
    scl: PileupData,
    gp0s,
    grid_alpha,
    doublet_prior=0.5,
    write_pair=False,
    min_total=0,
    min_uniq=0,
    min_snp=0,
    llksAB_fn=None,
):
    """Pass 2 + decision + .sing2/.pair/.best lines (cmd_cram_demuxlet.cpp:576-875).

    llksAB_fn: optional override that returns (llksAB, llksA0, llks00) for a
    cellid — used to validate the TPU engine's LLKs against the reference
    decision logic.
    """
    nv = scl.nv
    nA = len(grid_alpha)
    sing2 = ["BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\tPOSTPRB"]
    pair = ["BARCODE\tSM1.ID\tSM2.ID\tLLK12\tPOSTPRB"] if write_pair else None
    best = [
        "BARCODE\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tBEST\tSNG.1ST\tSNG.LLK1\t"
        "SNG.2ND\tSNG.LLK2\tSNG.LLK0\tDBL.1ST\tDBL.2ND\tALPHA\tLLK12\tLLK1\t"
        "LLK2\tLLK10\tLLK20\tLLK00\tPRB.DBL\tPRB.SNG1"
    ]
    for bc, i in scl.bc_order():
        if (
            scl.cell_totl[i] < min_total
            or scl.cell_uniq[i] < min_uniq
            or scl.n_cell_snps(i) < min_snp
        ):
            continue
        if not scl.cell_snps(i):
            continue  # reference `snps.empty()` check at :592
        if llksAB_fn is not None:
            llksAB, llksA0, llks00 = llksAB_fn(i)
        else:
            llksAB, llksA0, llks00 = pass2_cell(scl, gp0s, i, grid_alpha)

        maxLLK = -1e300
        for j in range(nv):
            for k in range(nv):
                for n in range(nA):
                    if maxLLK < llksAB[j, k, n]:
                        maxLLK = llksAB[j, k, n]

        sumSingle = 0.0
        sumDouble = 0.0
        for j in range(nv):
            sumSingle += math.exp(llksAB[j, 0, 0] - maxLLK) * (1.0 - doublet_prior) / nv
            for k in range(nv):
                if j == k:
                    continue
                for n in range(1, nA):
                    sumDouble += (
                        math.exp(llksAB[j, k, n] - maxLLK)
                        * doublet_prior
                        / nv
                        / (nv - 1)
                        / (nA - 1)
                        / (2.0 if grid_alpha[n] == 0.5 else 1.0)
                    )

        iSing1 = iSing2 = -1
        maxSing1 = maxSing2 = -1e300
        for j in range(nv):
            if maxSing1 < llksAB[j, 0, 0]:
                maxSing2 = maxSing1
                iSing2 = iSing1
                iSing1 = j
                maxSing1 = llksAB[j, 0, 0]
            elif maxSing2 < llksAB[j, 0, 0]:
                iSing2 = j
                maxSing2 = llksAB[j, 0, 0]
            sing2.append(
                "%s\t%s\t%d\t%d\t%d\t%d\t%.4f\t%.4f\t%.3g"
                % (
                    bc,
                    scl.sample_ids[j],
                    scl.cell_totl[i],
                    scl.cell_pass[i],
                    scl.cell_uniq[i],
                    scl.n_cell_snps(i),
                    llksAB[j, 0, 0],
                    llks00[0],
                    math.exp(llksAB[j, 0, 0] - maxLLK)
                    * (1.0 - doublet_prior)
                    / nv
                    / sumSingle,
                )
            )

        if write_pair:
            for j in range(nv):
                pair.append(
                    "%s\t%s\t%s\t%.3f\t%.5f\t%.5g"
                    % (
                        bc,
                        scl.sample_ids[j],
                        scl.sample_ids[j],
                        grid_alpha[0],
                        llksAB[j, 0, 0],
                        math.exp(llksAB[j, 0, 0] - maxLLK)
                        * (1.0 - doublet_prior)
                        / nv
                        / (sumSingle + sumDouble),
                    )
                )
                for k in range(nv):
                    for n in range(nA):
                        if n > 0 and j != k:
                            if j > k and grid_alpha[n] == 0.5:
                                continue
                            pair.append(
                                "%s\t%s\t%s\t%.3f\t%.5f\t%.5g"
                                % (
                                    bc,
                                    scl.sample_ids[j],
                                    scl.sample_ids[k],
                                    grid_alpha[n],
                                    llksAB[j, k, n],
                                    math.exp(llksAB[j, k, n] - maxLLK)
                                    * doublet_prior
                                    / nv
                                    / (nv - 1)
                                    / (nA - 1)
                                    / (sumSingle + sumDouble),
                                )
                            )

        jBest = kBest = alphaBest = -1
        maxAB = -1e300
        for j in range(nv):
            for k in range(nv):
                if j == k:
                    continue
                for n in range(1, nA):
                    if maxAB < llksAB[j, k, n]:
                        jBest, kBest, alphaBest = j, k, n
                        maxAB = llksAB[j, k, n]

        singLLK1 = llksAB[iSing1, 0, 0]
        singLLK2 = llksAB[iSing2, 0, 0]
        singLLK0 = llks00[0]
        pairLLK12 = llksAB[jBest, kBest, alphaBest]
        pairLLK1 = llksAB[jBest, 0, 0]
        pairLLK2 = llksAB[kBest, 0, 0]
        # NOTE the reference's flat-index quirk (:824-825): llksAB[jBest*nv*nA
        # + alphaBest] pairs jBest with *sample 0* at alphaBest, NOT llksA0.
        pairLLK10 = llksAB[jBest, 0, alphaBest]
        pairLLK20 = llksAB[kBest, 0, alphaBest]
        pairLLK00 = llks00[alphaBest]
        postDoublet = sumDouble / (sumSingle + sumDouble)
        postSinglet = math.exp(singLLK1 - maxLLK) * (1.0 - doublet_prior) / nv / sumSingle

        row = "%s\t%d\t%d\t%d\t%d\t" % (
            bc,
            scl.cell_totl[i],
            scl.cell_pass[i],
            scl.cell_uniq[i],
            scl.n_cell_snps(i),
        )
        if pairLLK12 > pairLLK1 and pairLLK12 > pairLLK2 and pairLLK12 > singLLK1 + 2:
            row += "DBL-%s-%s-%.3f" % (
                scl.sample_ids[jBest],
                scl.sample_ids[kBest],
                grid_alpha[alphaBest],
            )
        elif singLLK1 > singLLK2 + 2:
            row += "SNG-%s" % scl.sample_ids[iSing1]
        else:
            row += "AMB-%s-%s-%s/%s" % (
                scl.sample_ids[iSing1],
                scl.sample_ids[iSing2],
                scl.sample_ids[jBest],
                scl.sample_ids[kBest],
            )
        row += "\t%s\t%.4f" % (scl.sample_ids[iSing1], singLLK1)
        row += "\t%s\t%.4f\t%.4f" % (scl.sample_ids[iSing2], singLLK2, singLLK0)
        row += "\t%s\t%s\t%.3f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.3g\t%.3g" % (
            scl.sample_ids[jBest],
            scl.sample_ids[kBest],
            grid_alpha[alphaBest],
            pairLLK12,
            pairLLK1,
            pairLLK2,
            pairLLK10,
            pairLLK20,
            pairLLK00,
            postDoublet,
            postSinglet,
        )
        best.append(row)
    return sing2, pair, best
