"""Dense likelihood kernels over the slot representation in plain PyTorch
(port of ``demuxlet_tpu/models/likelihood.py``).

The reference every exact-mode test of the port compares to, in f64 or
f32: ``lograw = counts @ LUT``, the telescoped normalisations (GL:
normalise, +1e-6, renormalise; mixture table: max-normalise, +1e-6,
max-renormalise), then the (l, m) genotype contraction and a masked log
sum over the slot axis. The pair terms keep the JAX module's (l, m)
l-major order and its product ``(g_j[l] * g_k[m]) * t``
(cmd_cram_demuxlet.cpp:671-684). It never runs on the card's main path.

It is also the engine's dense route (``DemuxEngine.run`` on
``host/slots.py`` count slots), which the user chooses by a flag, as the
JAX package's XLA path: ``--exact-kernel xla``, exact ``--cap-BQ`` > 126
(beyond the u8 observation codes of the kernel route) and exact
``--precision f32``. It has no Pallas kernel in the JAX package, so it
stays plain torch on the card.
"""

from __future__ import annotations

import torch


def singlet_llks(cnt, msk, gps_g, gp0_g, logf, dtype=torch.float64):
    """Pass 1: per-(cell, sample) singlet log-likelihoods
    (``singlet_llks_impl`` :26).

    cnt (B, S, NB) counts; msk (B, S) bool; gps_g (B, S, V, 3) genotype
    posteriors gathered per slot; gp0_g (B, S, 3) background posteriors;
    logf (NB, 3) singlet LUT. Returns (llk (B, V), llk0 (B,))."""
    cnt, logf = cnt.to(dtype), logf.to(dtype)
    gps_g, gp0_g = gps_g.to(dtype), gp0_g.to(dtype)
    lograw = torch.einsum("bsn,ng->bsg", cnt, logf)
    mx = torch.amax(lograw, dim=-1, keepdim=True)
    gl = torch.exp(lograw - mx)
    gl = gl / gl.sum(dim=-1, keepdim=True)
    gl = gl + 1e-6
    gl = gl / gl.sum(dim=-1, keepdim=True)
    m = msk.to(dtype)
    contrib = torch.log(torch.einsum("bsg,bsvg->bsv", gl, gps_g))
    llk = (contrib * m[..., None]).sum(dim=1)
    contrib0 = torch.log(torch.einsum("bsg,bsg->bs", gl, gp0_g))
    llk0 = (contrib0 * m).sum(dim=1)
    return llk, llk0


def _pair_block(cnt, msk, gps_g, gp0_g, w, n_alpha, dtype):
    """Pair-search LLKs of one slot chunk: (llk_ab (B, V, V, A),
    llk_00 (B, A)), to be summed over chunks."""
    B, S = cnt.shape[0], cnt.shape[1]
    V = gps_g.shape[2]
    A = n_alpha
    lograw = torch.einsum("bsn,nx->bsx", cnt, w)  # (B, S, A*9)
    mx = torch.amax(lograw, dim=-1, keepdim=True)
    t = torch.exp(lograw - mx)
    t = t + 1e-6
    t = t / torch.amax(t, dim=-1, keepdim=True)
    t = t.reshape(B, S, A, 3, 3)
    m = msk.to(dtype)

    cols = []
    for j in range(V):
        for k in range(V):
            inner = None
            for l in range(3):
                for mm in range(3):
                    p = gps_g[:, :, j, l] * gps_g[:, :, k, mm]  # (B, S)
                    term = p[:, :, None] * t[:, :, :, l, mm]  # (B, S, A)
                    inner = term if inner is None else inner + term
            cols.append((torch.log(inner) * m[:, :, None]).sum(dim=1))
    llk_ab = torch.stack(cols, dim=1).reshape(B, V, V, A)

    # background pair term llks00 (:700-709), the same (l, m) order
    t00 = None
    for l in range(3):
        for mm in range(3):
            p = gp0_g[:, :, l] * gp0_g[:, :, mm]
            term = p[:, :, None] * t[:, :, :, l, mm]
            t00 = term if t00 is None else t00 + term
    llk_00 = (torch.log(t00) * m[:, :, None]).sum(dim=1)
    return llk_ab, llk_00


def pair_llks(cnt, msk, gps_g, gp0_g, w, n_alpha, slot_chunk=0,
              dtype=torch.float64):
    """Pass 2: doublet pair-search LLKs (``pair_llks_impl`` :104).

    cnt (B, S, NB); msk (B, S); gps_g (B, S, V, 3); gp0_g (B, S, 3);
    w (NB, A*9) pair LUT. Returns (llk_ab (B, V, V, A), llk_00 (B, A)).
    slot_chunk > 0 sums chunks of that many slots in slot order, from
    zeros as the JAX scan does, to bound the (B, S, A) intermediates; the
    last chunk is shorter instead of padded."""
    cnt, w = cnt.to(dtype), w.to(dtype)
    gps_g, gp0_g = gps_g.to(dtype), gp0_g.to(dtype)
    S = cnt.shape[1]
    if slot_chunk <= 0 or S <= slot_chunk:
        return _pair_block(cnt, msk, gps_g, gp0_g, w, n_alpha, dtype)
    llk_ab = llk_00 = None
    for s0 in range(0, S, slot_chunk):
        sl = slice(s0, s0 + slot_chunk)
        ab, z0 = _pair_block(cnt[:, sl], msk[:, sl], gps_g[:, sl],
                             gp0_g[:, sl], w, n_alpha, dtype)
        if llk_ab is None:
            llk_ab, llk_00 = torch.zeros_like(ab), torch.zeros_like(z0)
        llk_ab, llk_00 = llk_ab + ab, llk_00 + z0
    return llk_ab, llk_00


def block_llks(idx, msk, cnt, gps, gp0, logf, w, n_alpha, slot_chunk=0,
               dtype=torch.float64):
    """One count-slot block from the run's tables (the JAX engine's
    ``_run_block``): the gps and gp0 rows taken by idx (B, S), then the
    singlet and pair LLKs. gps (NS, V, 3), gp0 (NS, 3), logf and w in
    ``dtype`` on the device of idx, msk (B, S) and cnt (B, S, NB).
    Returns (llk, llk0, llk_ab, llk_00) on that device."""
    B, S = idx.shape
    ns, nv = gps.shape[:2]
    flat = idx.reshape(-1)
    gps_g = gps.reshape(ns, nv * 3).index_select(0, flat).view(B, S, nv, 3)
    gp0_g = gp0.index_select(0, flat).view(B, S, 3)
    llk, llk0 = singlet_llks(cnt, msk, gps_g, gp0_g, logf, dtype=dtype)
    llk_ab, llk_00 = pair_llks(cnt, msk, gps_g, gp0_g, w, n_alpha,
                               slot_chunk=slot_chunk, dtype=dtype)
    return llk, llk0, llk_ab, llk_00
