"""The plain reference: demuxlet's two likelihood passes, its decision and
its three output files, in plain PyTorch and Python.

It follows demuxlet's definitions (cmd_cram_demuxlet.cpp): per (cell, SNP)
slot the per-UMI genotype-likelihood factors multiply, are normalised, get
1e-6 added and are normalised again; the singlet pass scores each donor and
the pool's mean genotype, the pair pass each donor pair at each alpha of the
grid; the decision takes first-occurrence argmaxes, the -1e300-seeded second
best and the doublet posterior; the renderer prints demuxlet's columns.
The products are taken as sums of logs. Nothing here imports the program:
the reference reads the library's arrays and the pool's genotype posteriors,
which the benchmark made, and computes everything else itself. ``dtype``
float32 gives the control (the same computation one precision below the
configuration's float64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# demuxlet's Phred table: 10^(-q/10), with q of 0 and 1 taken as 0.75
PHRED_ERR = [0.75, 0.75] + [0.1 ** (q * 0.1) for q in range(2, 256)]


def factor_tables(grid, cap_bq):
    """(f (NB, 3), w (NB, A, 3, 3)) float64: the per-UMI factors of an
    observation of allele a at base quality q (row a * (cap_bq + 1) + q) to
    the singlet genotypes and to the pair (l, m) genotypes at each alpha."""
    nq = cap_bq + 1
    A = len(grid)
    f = np.empty((2 * nq, 3))
    w = np.empty((2 * nq, A, 3, 3))
    for a in (0, 1):
        for q in range(nq):
            e3 = PHRED_ERR[q] / 3.0
            mat = 1.0 - PHRED_ERR[q]
            pr = mat if a == 0 else e3
            pa = mat if a == 1 else e3
            f[a * nq + q] = (pr, 0.5 - e3, pa)
            for n, alpha in enumerate(grid):
                for l in range(3):
                    for m in range(3):
                        p = 0.5 * l + (m - l) * 0.5 * alpha
                        w[a * nq + q, n, l, m] = pr * (1.0 - p) + pa * p
    return f, w


def slot_counts(lib, cap_bq, device):
    """The library's slots: (slot_cell, slot_snp, counts (S, P) of each
    slot's observations of allele 0 or 1 per present (allele, quality) bin,
    bins (P,)), and nsnp (n,), the covered SNPs per cell."""
    n = lib.n_barcodes
    snp = torch.as_tensor(lib.obs_snp, device=device).to(torch.int64)
    al = torch.as_tensor(lib.obs_allele, device=device).to(torch.int64)
    bq = torch.as_tensor(lib.obs_bq, device=device).to(torch.int64)
    lengths = torch.as_tensor(np.diff(lib.cell_ptr), device=device)
    cell = torch.repeat_interleave(torch.arange(n, device=device), lengths)
    new = torch.ones(snp.numel(), dtype=torch.bool, device=device)
    new[1:] = (snp[1:] != snp[:-1]) | (cell[1:] != cell[:-1])
    slot = torch.cumsum(new.to(torch.int64), 0) - 1
    slot_cell, slot_snp = cell[new], snp[new]
    nsnp = torch.bincount(slot_cell, minlength=n)
    keep = al < 2
    bins, inv = torch.unique(al[keep] * (cap_bq + 1)
                             + torch.clamp(bq[keep], max=cap_bq),
                             return_inverse=True)
    counts = torch.bincount(slot[keep] * bins.numel() + inv,
                            minlength=slot_cell.numel() * bins.numel())
    return (slot_cell, slot_snp, counts.view(-1, bins.numel()), bins,
            nsnp.cpu().numpy())


def llks(lib, gps, cfg, device, dtype=torch.float64, chunk=1 << 19):
    """Both passes over the library: dict of llk (n, V), llk0 (n,),
    llk_ab (n, V, V, A), llk_00 (n, A) as float64 numpy (computed in
    ``dtype``), and nsnp (n,)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    grid, cap_bq = cfg["grid_alpha"], cfg["cap_bq"]
    n, V, A = lib.n_barcodes, gps.shape[1], len(grid)
    slot_cell, slot_snp, counts, bins, nsnp = slot_counts(lib, cap_bq, device)
    f, w = factor_tables(grid, cap_bq)
    rows = bins.cpu().numpy()
    logf = torch.as_tensor(np.log(f[rows]), dtype=dtype, device=device)
    logw = torch.as_tensor(np.log(w[rows]).reshape(len(rows), -1),
                           dtype=dtype, device=device)
    g = torch.as_tensor(gps, dtype=dtype, device=device)
    g0 = g.sum(dim=1) / V
    out = dict(
        llk=torch.zeros(n, V, dtype=dtype, device=device),
        llk0=torch.zeros(n, dtype=dtype, device=device),
        llk_ab=torch.zeros(n, V, V, A, dtype=dtype, device=device),
        llk_00=torch.zeros(n, A, dtype=dtype, device=device),
    )
    for s0 in range(0, slot_cell.numel(), chunk):
        c = counts[s0:s0 + chunk].to(dtype)
        cells, snps = slot_cell[s0:s0 + chunk], slot_snp[s0:s0 + chunk]
        gs, g0s = g[snps], g0[snps]
        # singlet pass: GL normalised, + 1e-6, normalised again
        gl = torch.softmax(c @ logf, dim=1) + 1e-6
        gl = gl / gl.sum(dim=1, keepdim=True)
        out["llk"].index_add_(0, cells, torch.log(
            torch.einsum("mg,mvg->mv", gl, gs)))
        out["llk0"].index_add_(0, cells, torch.log((gl * g0s).sum(dim=1)))
        # pair pass: pG over max, + 1e-6, over max again
        lw = c @ logw
        pg = torch.exp(lw - lw.max(dim=1, keepdim=True).values) + 1e-6
        pg = (pg / pg.max(dim=1, keepdim=True).values).view(-1, A, 3, 3)
        half = torch.einsum("mjl,malq->mjaq", gs, pg)
        out["llk_ab"].index_add_(0, cells, torch.log(
            torch.einsum("mjaq,mkq->mjka", half, gs)))
        out["llk_00"].index_add_(0, cells, torch.log(
            torch.einsum("ml,malq,mq->ma", g0s, pg, g0s)))
        del c, gs, g0s, gl, lw, pg, half
    res = {k: v.to(torch.float64).cpu().numpy() for k, v in out.items()}
    res["nsnp"] = nsnp
    return res


def decide(ref, cfg, dtype=np.float64):
    """demuxlet's decision over the reference's LLKs (vectorised over
    cells, in ``dtype``): adds max_llk, sing_col, sum_single, sum_double,
    i_sing1, i_sing2, max_sing2, best_flat, pair_llk12/10/20 to ``ref``."""
    grid, prior = cfg["grid_alpha"], cfg["doublet_prior"]
    ab = ref["llk_ab"].astype(dtype)
    n, V, _, A = ab.shape
    seed = -1e300 if dtype == np.float64 else float(np.finfo(dtype).min)
    flat = ab.reshape(n, -1)
    max_llk = np.maximum(flat.max(axis=1), seed)
    sing = ab[:, :, 0, 0]
    with np.errstate(under="ignore"):
        sum_single = np.exp(sing - max_llk[:, None]).sum(axis=1) \
            * dtype(1.0 - prior) / V
        wts = np.zeros((V, V, A), dtype)
        for a in range(1, A):
            wts[:, :, a] = prior / V / (V - 1) / (A - 1) \
                / (2.0 if grid[a] == 0.5 else 1.0)
        for j in range(V):
            wts[j, j, :] = 0.0
        sum_double = np.einsum("cjka,jka->c",
                               np.exp(ab - max_llk[:, None, None, None]), wts)
    rows = np.arange(n)
    i1 = np.argmax(sing, axis=1)
    masked = sing.copy()
    masked[rows, i1] = -np.inf
    i2 = np.argmax(masked, axis=1)
    mask = np.ones((V, V, A), bool)
    mask[np.arange(V), np.arange(V), :] = False
    mask[:, :, 0] = False
    best = np.argmax(np.where(mask.reshape(-1), flat, -np.inf), axis=1)
    jb, kb, xb = best // (V * A), (best // A) % V, best % A
    ref.update(
        max_llk=max_llk, sing_col=sing, sum_single=sum_single,
        sum_double=sum_double, i_sing1=i1, i_sing2=i2,
        max_sing2=np.maximum(masked[rows, i2], seed), best_flat=best,
        pair_llk12=ab[rows, jb, kb, xb], pair_llk10=ab[rows, jb, 0, xb],
        pair_llk20=ab[rows, kb, 0, xb])
    for k in list(ref):
        if isinstance(ref[k], np.ndarray) and ref[k].dtype.kind == "f":
            ref[k] = ref[k].astype(np.float64)
    return ref


def render(rows, stats, sample_ids, cfg):
    """demuxlet's .single, .sing2 and .best lines (headers first, cells in
    barcode order) from decided rows: llk, llk0, sing_col, llk_00,
    max_llk, sum_single, sum_double, i_sing1, i_sing2, max_sing2,
    best_flat, pair_llk12, pair_llk10, pair_llk20 (numpy, one row per
    cell), with stats' barcodes, totl, pass_, uniq and nsnp."""
    grid, prior = cfg["grid_alpha"], cfg["doublet_prior"]
    V, A = len(sample_ids), len(grid)
    head = ("BARCODE\tSM_ID\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tLLK1\tLLK0\t"
            "POSTPRB")
    single, sing2 = [head], [head]
    best = ["BARCODE\tRD.TOTL\tRD.PASS\tRD.UNIQ\tN.SNP\tBEST\tSNG.1ST\t"
            "SNG.LLK1\tSNG.2ND\tSNG.LLK2\tSNG.LLK0\tDBL.1ST\tDBL.2ND\tALPHA\t"
            "LLK12\tLLK1\tLLK2\tLLK10\tLLK20\tLLK00\tPRB.DBL\tPRB.SNG1"]
    L = {k: np.asarray(v).tolist() for k, v in rows.items()}
    totl, pas, uniq, nsnp = (np.asarray(stats[k]).tolist()
                             for k in ("totl", "pass_", "uniq", "nsnp"))
    # the posteriors' denominators stay numpy floats: demuxlet divides in
    # C, so a sum that underflowed to 0 gives inf or nan, not an error
    sum_single = np.asarray(rows["sum_single"], np.float64)
    log, exp = math.log, math.exp
    with np.errstate(divide="ignore", invalid="ignore"):
        for bc, c in sorted((b, i) for i, b in enumerate(stats["barcodes"])):
            head = "%s\t%s\t%d\t%d\t%d\t%d\t" % (bc, "%s", totl[c], pas[c],
                                                uniq[c], nsnp[c])
            llk, llk0 = L["llk"][c], L["llk0"][c]
            total = -1e300  # the sequential log-sum-exp over donors
            for cur in llk:
                if total > cur:
                    total = total + log(1.0 + exp(cur - total))
                else:
                    total = cur + log(1.0 + exp(total - cur))
            for j in range(V):
                single.append(head % sample_ids[j] + "%.5f\t%.5f\t%.3g" % (
                    llk[j], llk0, exp(llk[j] - total)))
            if nsnp[c] == 0:
                continue
            sing, z0 = L["sing_col"][c], L["llk_00"][c]
            max_llk = L["max_llk"][c]
            for j in range(V):
                sing2.append(head % sample_ids[j] + "%.4f\t%.4f\t%.3g" % (
                    sing[j], z0[0], exp(sing[j] - max_llk) * (1.0 - prior)
                    / V / sum_single[c]))
            i1, i2 = L["i_sing1"][c], L["i_sing2"][c]
            b = int(L["best_flat"][c])
            jb, kb, xb = b // (V * A), (b // A) % V, b % A
            llk1, llk2, p12 = sing[i1], L["max_sing2"][c], L["pair_llk12"][c]
            ss, sd = sum_single[c], L["sum_double"][c]
            if p12 > sing[jb] and p12 > sing[kb] and p12 > llk1 + 2:
                call = "DBL-%s-%s-%.3f" % (sample_ids[jb], sample_ids[kb],
                                           grid[xb])
            elif llk1 > llk2 + 2:
                call = "SNG-%s" % sample_ids[i1]
            else:
                call = "AMB-%s-%s-%s/%s" % (sample_ids[i1], sample_ids[i2],
                                            sample_ids[jb], sample_ids[kb])
            best.append(
                "%s\t%d\t%d\t%d\t%d\t%s\t%s\t%.4f\t%s\t%.4f\t%.4f\t%s\t%s"
                "\t%.3f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.4f\t%.3g\t%.3g" % (
                    bc, totl[c], pas[c], uniq[c], nsnp[c], call,
                    sample_ids[i1], llk1, sample_ids[i2], llk2, z0[0],
                    sample_ids[jb],
                    sample_ids[kb], grid[xb], p12, sing[jb], sing[kb],
                    L["pair_llk10"][c], L["pair_llk20"][c], z0[xb],
                    sd / (ss + sd),
                    exp(llk1 - max_llk) * (1.0 - prior) / V / ss))
    return single, sing2, best
