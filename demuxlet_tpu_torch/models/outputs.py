"""Decision rules, posteriors, and output-file rendering.

Consumes the device-computed LLK tensors and renders the reference's four
output files byte-identically (cmd_cram_demuxlet.cpp:470-517 .single,
:746-770 .sing2, :772-797 .pair, :830-875 .best), including:
  - the sequential -1e300-seeded log-sum-exp over samples (:476-501)
  - strict-< running argmaxes (first-wins tie semantics)
  - the pairLLK10/20 flat-index quirk (:824-825): jBest paired with sample 0
  - the .pair header/row column mismatch (5 names, 6 columns)
  - the hard-coded "+2" log-likelihood margins (:837,:844)
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import IO, List, Optional, Sequence

import numpy as np


@dataclass
class CellStats:
    """Per-cell metadata, in pileup cell-id numbering."""

    barcodes: List[str]
    totl: np.ndarray  # RD.TOTL
    pass_: np.ndarray  # RD.PASS
    uniq: np.ndarray  # RD.UNIQ
    nsnp: np.ndarray  # N.SNP (covered SNPs per cell)

    def bc_order(self):
        return sorted((b, i) for i, b in enumerate(self.barcodes))


def _passes(stats: CellStats, i: int, min_total: int, min_uniq: int, min_snp: int) -> bool:
    return not (
        stats.totl[i] < min_total
        or stats.uniq[i] < min_uniq
        or stats.nsnp[i] < min_snp
    )


def write_single(
    fh: IO[str],
    stats: CellStats,
    sample_ids: Sequence[str],
    llks: np.ndarray,  # (ncells, nv)
    llk0s: np.ndarray,  # (ncells,)
    min_total: int = 0,
    min_uniq: int = 0,
    min_snp: int = 0,
) -> None:
    nv = len(sample_ids)
    fh.write("BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\tPOSTPRB\n")
    # native C++ renderer first (byte parity: tests/test_native_render.py)
    from demuxlet_tpu_torch.native import render as _native_render

    if _native_render.available() and _native_render.write_single(
        stats, sample_ids, llks, llk0s, fh, min_total, min_uniq, min_snp
    ):
        return
    # hoisted plain-Python views (see write_pass2_compact) — bytes unchanged
    l_totl = np.asarray(stats.totl).tolist()
    l_pass = np.asarray(stats.pass_).tolist()
    l_uniq = np.asarray(stats.uniq).tolist()
    l_nsnp = np.asarray(stats.nsnp).tolist()
    l_llks = np.asarray(llks, np.float64).tolist()
    l_llk0 = np.asarray(llk0s, np.float64).tolist()
    log, exp = math.log, math.exp
    lines: List[str] = []
    for bc, c in stats.bc_order():
        totl, uniq, nsnp = l_totl[c], l_uniq[c], l_nsnp[c]
        if totl < min_total or uniq < min_uniq or nsnp < min_snp:
            continue
        pass_ = l_pass[c]
        row = l_llks[c]
        llk0 = l_llk0[c]
        sum_llk = -1e300
        for j in range(nv):
            cur = row[j]
            if sum_llk > cur:
                sum_llk = sum_llk + log(1.0 + exp(cur - sum_llk))
            else:
                sum_llk = cur + log(1.0 + exp(sum_llk - cur))
        for j in range(nv):
            lines.append(
                "%s\t%s\t%d\t%d\t%d\t%d\t%.5f\t%.5f\t%.3g\n"
                % (bc, sample_ids[j], totl, pass_, uniq, nsnp,
                   row[j], llk0, exp(row[j] - sum_llk))
            )
        if len(lines) >= 65536:
            fh.write("".join(lines))
            lines.clear()
    fh.write("".join(lines))


def write_pass2(
    stats: CellStats,
    sample_ids: Sequence[str],
    llk_ab: np.ndarray,  # (ncells, nv, nv, nA)
    llk_00: np.ndarray,  # (ncells, nA)
    grid_alpha: Sequence[float],
    doublet_prior: float,
    wsing2: IO[str],
    wbest: IO[str],
    wpair: Optional[IO[str]] = None,
    min_total: int = 0,
    min_uniq: int = 0,
    min_snp: int = 0,
) -> None:
    """Render .sing2, .best and optionally .pair from pass-2 LLKs."""
    nv = len(sample_ids)
    na = len(grid_alpha)
    wsing2.write(
        "BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\tPOSTPRB\n"
    )
    if wpair is not None:
        wpair.write("BARCODE\tSM1.ID\tSM2.ID\tLLK12\tPOSTPRB\n")
    wbest.write(
        "BARCODE\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tBEST\tSNG.1ST\tSNG.LLK1\t"
        "SNG.2ND\tSNG.LLK2\tSNG.LLK0\tDBL.1ST\tDBL.2ND\tALPHA\tLLK12\tLLK1\t"
        "LLK2\tLLK10\tLLK20\tLLK00\tPRB.DBL\tPRB.SNG1\n"
    )

    # doublet argmax mask: j != k, n >= 1 (flattened C order == loop order)
    dbl_mask = np.ones((nv, nv, na), dtype=bool)
    for j in range(nv):
        dbl_mask[j, j, :] = False
    dbl_mask[:, :, 0] = False

    # ---- vectorized decision pass over all cells (the per-cell math of
    # cmd_cram_demuxlet.cpp:713-828, batched; the render loop below only
    # formats). Weight layout identical to the scalar loops.
    AB = np.asarray(llk_ab, dtype=np.float64)
    Z0 = np.asarray(llk_00, dtype=np.float64)
    ncell = AB.shape[0]
    v_max_llk = np.maximum(AB.reshape(ncell, -1).max(axis=1), -1e300)
    sing_col = AB[:, :, 0, 0]  # (n, nv)
    v_sum_single = (
        np.exp(sing_col - v_max_llk[:, None]).sum(axis=1)
        * (1.0 - doublet_prior)
        / nv
    )
    dbl_w = np.zeros((nv, nv, na))
    if nv > 1 and na > 1:  # reference loops never execute otherwise (:726)
        for n in range(1, na):
            dbl_w[:, :, n] = (
                doublet_prior
                / nv
                / (nv - 1)
                / (na - 1)
                / (2.0 if grid_alpha[n] == 0.5 else 1.0)
            )
        for j in range(nv):
            dbl_w[j, j, :] = 0.0
    v_sum_double = np.einsum(
        "cjkn,jkn->c", np.exp(AB - v_max_llk[:, None, None, None]), dbl_w
    )
    # running strict-< argmax semantics == first-occurrence argmax; the
    # second best is the first-occurrence argmax with the winner masked
    v_i1 = np.argmax(sing_col, axis=1)
    masked = sing_col.copy()
    masked[np.arange(ncell), v_i1] = -np.inf
    v_i2 = np.argmax(masked, axis=1)
    # second-best VALUE from the masked max, seeded at -1e300 like the
    # reference's running maxSing2 (degenerate nv==1: no second sample)
    v_max2 = np.maximum(masked[np.arange(ncell), v_i2], -1e300)
    flat = np.where(dbl_mask.reshape(-1)[None, :], AB.reshape(ncell, -1), -np.inf)
    v_best = np.argmax(flat, axis=1)

    # hoisted plain-Python views (see write_pass2_compact) — bytes unchanged
    l_totl = np.asarray(stats.totl).tolist()
    l_pass = np.asarray(stats.pass_).tolist()
    l_uniq = np.asarray(stats.uniq).tolist()
    l_nsnp = np.asarray(stats.nsnp).tolist()
    for bc, i in stats.bc_order():
        totl_i, uniq_i, nsnp_i = l_totl[i], l_uniq[i], l_nsnp[i]
        if totl_i < min_total or uniq_i < min_uniq or nsnp_i < min_snp:
            continue
        if nsnp_i == 0:
            continue  # reference `snps.empty()` skip (:592)
        pass_i = l_pass[i]
        ab = AB[i]
        z0 = Z0[i]
        max_llk = v_max_llk[i]
        sum_single = v_sum_single[i]
        sum_double = v_sum_double[i]
        i_sing1 = int(v_i1[i])
        i_sing2 = int(v_i2[i])

        for j in range(nv):
            v = ab[j, 0, 0]
            wsing2.write(
                "%s\t%s\t%d\t%d\t%d\t%d\t%.4f\t%.4f\t%.3g\n"
                % (
                    bc,
                    sample_ids[j],
                    totl_i,
                    pass_i,
                    uniq_i,
                    nsnp_i,
                    v,
                    z0[0],
                    math.exp(v - max_llk) * (1.0 - doublet_prior) / nv / sum_single,
                )
            )

        if wpair is not None:
            for j in range(nv):
                wpair.write(
                    "%s\t%s\t%s\t%.3f\t%.5f\t%.5g\n"
                    % (
                        bc,
                        sample_ids[j],
                        sample_ids[j],
                        grid_alpha[0],
                        ab[j, 0, 0],
                        math.exp(ab[j, 0, 0] - max_llk)
                        * (1.0 - doublet_prior)
                        / nv
                        / (sum_single + sum_double),
                    )
                )
                for k in range(nv):
                    for n in range(1, na):
                        if j == k:
                            continue
                        if j > k and grid_alpha[n] == 0.5:
                            continue
                        wpair.write(
                            "%s\t%s\t%s\t%.3f\t%.5f\t%.5g\n"
                            % (
                                bc,
                                sample_ids[j],
                                sample_ids[k],
                                grid_alpha[n],
                                ab[j, k, n],
                                math.exp(ab[j, k, n] - max_llk)
                                * doublet_prior
                                / nv
                                / (nv - 1)
                                / (na - 1)
                                / (sum_single + sum_double),
                            )
                        )

        j_best, k_best, alpha_best = np.unravel_index(int(v_best[i]), ab.shape)

        sing_llk1 = ab[i_sing1, 0, 0]
        sing_llk2 = float(v_max2[i])
        sing_llk0 = z0[0]
        pair_llk12 = ab[j_best, k_best, alpha_best]
        pair_llk1 = ab[j_best, 0, 0]
        pair_llk2 = ab[k_best, 0, 0]
        pair_llk10 = ab[j_best, 0, alpha_best]  # flat-index quirk (:824)
        pair_llk20 = ab[k_best, 0, alpha_best]
        pair_llk00 = z0[alpha_best]
        post_dbl = sum_double / (sum_single + sum_double)
        post_sng = (
            math.exp(sing_llk1 - max_llk) * (1.0 - doublet_prior) / nv / sum_single
        )

        wbest.write(
            "%s\t%d\t%d\t%d\t%d\t"
            % (bc, totl_i, pass_i, uniq_i, nsnp_i)
        )
        if (
            pair_llk12 > pair_llk1
            and pair_llk12 > pair_llk2
            and pair_llk12 > sing_llk1 + 2
        ):
            wbest.write(
                "DBL-%s-%s-%.3f"
                % (sample_ids[j_best], sample_ids[k_best], grid_alpha[alpha_best])
            )
        elif sing_llk1 > sing_llk2 + 2:
            wbest.write("SNG-%s" % sample_ids[i_sing1])
        else:
            wbest.write(
                "AMB-%s-%s-%s/%s"
                % (
                    sample_ids[i_sing1],
                    sample_ids[i_sing2],
                    sample_ids[j_best],
                    sample_ids[k_best],
                )
            )
        wbest.write("\t%s\t%.4f" % (sample_ids[i_sing1], sing_llk1))
        wbest.write(
            "\t%s\t%.4f\t%.4f" % (sample_ids[i_sing2], sing_llk2, sing_llk0)
        )
        wbest.write(
            "\t%s\t%s\t%.3f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.3g\t%.3g\n"
            % (
                sample_ids[j_best],
                sample_ids[k_best],
                grid_alpha[alpha_best],
                pair_llk12,
                pair_llk1,
                pair_llk2,
                pair_llk10,
                pair_llk20,
                pair_llk00,
                post_dbl,
                post_sng,
            )
        )


def write_pass2_compact(
    stats: CellStats,
    sample_ids: Sequence[str],
    compact,
    grid_alpha: Sequence[float],
    doublet_prior: float,
    wsing2: IO[str],
    wbest: IO[str],
    min_total: int = 0,
    min_uniq: int = 0,
    min_snp: int = 0,
) -> None:
    """Render .sing2/.best from the device-side decision pass
    (models/decision.CompactResult) — byte-identical to write_pass2 without
    ever fetching the full (V,V,A) LLK tensor. .pair needs the full tensor
    (use write_pass2 with --write-pair)."""
    nv = len(sample_ids)
    na = len(grid_alpha)
    wsing2.write(
        "BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\tPOSTPRB\n"
    )
    wbest.write(
        "BARCODE\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tBEST\tSNG.1ST\tSNG.LLK1\t"
        "SNG.2ND\tSNG.LLK2\tSNG.LLK0\tDBL.1ST\tDBL.2ND\tALPHA\tLLK12\tLLK1\t"
        "LLK2\tLLK10\tLLK20\tLLK00\tPRB.DBL\tPRB.SNG1\n"
    )
    # native C++ renderer (~1-2 us/row vs ~50 us here; byte parity pinned
    # by tests/test_native_render.py); Python loop below is the fallback
    from demuxlet_tpu_torch.native import render as _native_render

    if _native_render.available() and _native_render.write_pass2_compact(
        stats, sample_ids, compact, grid_alpha, doublet_prior,
        wsing2, wbest, min_total, min_uniq, min_snp,
    ):
        return
    # hoist every per-cell numpy access to plain Python lists once — numpy
    # scalar indexing + %-formatting per row dominated the render at 100K
    # cells; bytes are unchanged (same floats, same format ops)
    C = compact
    l_totl = np.asarray(stats.totl).tolist()
    l_pass = np.asarray(stats.pass_).tolist()
    l_uniq = np.asarray(stats.uniq).tolist()
    l_nsnp = np.asarray(stats.nsnp).tolist()
    l_max_llk = np.asarray(C.max_llk, np.float64).tolist()
    # keep the posterior DENOMINATORS as numpy scalars: pure-Python float
    # division raises ZeroDivisionError where the reference's C (and the
    # previous numpy path) produce IEEE inf/nan — sum_single can be an
    # exact 0.0 when every singlet underflows the max-shifted exp
    l_sum_single = np.asarray(C.sum_single, np.float64)
    l_sum_double = np.asarray(C.sum_double, np.float64).tolist()
    l_sing_col = np.asarray(C.sing_col, np.float64).tolist()
    l_llk00 = np.asarray(C.llk_00, np.float64).tolist()
    l_i1 = np.asarray(C.i_sing1).tolist()
    l_i2 = np.asarray(C.i_sing2).tolist()
    l_max2 = np.asarray(C.max_sing2, np.float64).tolist()
    l_best = np.asarray(C.best_flat).tolist()
    l_p12 = np.asarray(C.pair_llk12, np.float64).tolist()
    l_p10 = np.asarray(C.pair_llk10, np.float64).tolist()
    l_p20 = np.asarray(C.pair_llk20, np.float64).tolist()
    exp = math.exp
    lines2: List[str] = []
    linesb: List[str] = []
    for bc, i in stats.bc_order():
        totl, uniq, nsnp = l_totl[i], l_uniq[i], l_nsnp[i]
        if totl < min_total or uniq < min_uniq or nsnp < min_snp:
            continue
        if nsnp == 0:
            continue
        pass_ = l_pass[i]
        max_llk = l_max_llk[i]
        sum_single = l_sum_single[i]
        sum_double = l_sum_double[i]
        sing = l_sing_col[i]
        z0_0 = l_llk00[i][0]
        for j in range(nv):
            v = sing[j]
            lines2.append(
                "%s\t%s\t%d\t%d\t%d\t%d\t%.4f\t%.4f\t%.3g\n"
                % (bc, sample_ids[j], totl, pass_, uniq, nsnp, v, z0_0,
                   exp(v - max_llk) * (1.0 - doublet_prior) / nv / sum_single)
            )
        i_sing1 = l_i1[i]
        i_sing2 = l_i2[i]
        best = l_best[i]
        j_best, k_best, alpha_best = (
            best // (nv * na),
            (best // na) % nv,
            best % na,
        )
        sing_llk1 = sing[i_sing1]
        sing_llk2 = l_max2[i]
        pair_llk12 = l_p12[i]
        pair_llk1 = sing[j_best]
        pair_llk2 = sing[k_best]
        post_dbl = sum_double / (sum_single + sum_double)
        post_sng = (
            exp(sing_llk1 - max_llk) * (1.0 - doublet_prior) / nv
            / sum_single
        )
        if (
            pair_llk12 > pair_llk1
            and pair_llk12 > pair_llk2
            and pair_llk12 > sing_llk1 + 2
        ):
            call = "DBL-%s-%s-%.3f" % (
                sample_ids[j_best], sample_ids[k_best],
                grid_alpha[alpha_best],
            )
        elif sing_llk1 > sing_llk2 + 2:
            call = "SNG-%s" % sample_ids[i_sing1]
        else:
            call = "AMB-%s-%s-%s/%s" % (
                sample_ids[i_sing1], sample_ids[i_sing2],
                sample_ids[j_best], sample_ids[k_best],
            )
        linesb.append(
            "%s\t%d\t%d\t%d\t%d\t%s\t%s\t%.4f\t%s\t%.4f\t%.4f"
            "\t%s\t%s\t%.3f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.3g\t%.3g\n"
            % (
                bc, totl, pass_, uniq, nsnp, call,
                sample_ids[i_sing1], sing_llk1,
                sample_ids[i_sing2], sing_llk2, z0_0,
                sample_ids[j_best],
                sample_ids[k_best],
                grid_alpha[alpha_best],
                pair_llk12,
                pair_llk1,
                pair_llk2,
                l_p10[i],
                l_p20[i],
                l_llk00[i][alpha_best],
                post_dbl,
                post_sng,
            )
        )
        if len(lines2) >= 65536:
            wsing2.write("".join(lines2))
            wbest.write("".join(linesb))
            lines2.clear()
            linesb.clear()
    wsing2.write("".join(lines2))
    wbest.write("".join(linesb))
