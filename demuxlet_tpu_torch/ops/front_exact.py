"""Exact-mode front and the fused exact block step (port of
``demuxlet_tpu/ops/pallas_pair_exact.py``: ``_onehot_prod_front`` :980 with
the normalisation preamble of ``_pair_kernel_df`` :253-280, and
``demux_block_exact_impl`` :1235 on the unrolled path), in f64.

The TPU formed per-slot products of probabilities as df32 mantissa and
exponent planes because it has no f64 ALUs. Hopper has them, so the front
works in the log domain of ``models/likelihood.py``: per (cell, slot)

    lograw[c] = sum over UMI lanes u of lut[min(code_u, none_row)][c]
    t[c]      = (exp(lograw[c] - max over the mixture channels) + 1e-6)
                / (1 + 1e-6)
    gl        = the pass-1 GL table of the three singlet channels,
                (1, 0, 0) on a masked slot.

The lanes come as the wire-v2 parts (``ops/wire.unpack_wire_v2(...,
parts=True)``): the dense lanes and the sorted deep-lane tail, summed
without rebuilding the full lanes; full-lane codes are the case with no
tail.

``front_exact`` dispatches to the Hopper kernel K2' on a CUDA tensor and
to ``front_exact_plain`` on a CPU tensor; nothing falls back.
"""

from __future__ import annotations

import torch

from demuxlet_tpu_torch.ops.pair import _PLAIN_CHUNK_ELEMS
from demuxlet_tpu_torch.ops.pair_exact import pair_exact
from demuxlet_tpu_torch.ops.wire import (
    rebuild_lanes,
    unpack_block_inputs,
    unpack_wire_v2,
)
from demuxlet_tpu_torch.utils.spans import span

# the max of the smoothed mixture table: exp(0) + 1e-6, exact in f64
_TMAX = 1.0 + 1e-6


def front_exact(dense, lut, msk, cmask, gsel, tail=None, n_deep=0):
    """dense (B, S, U0) int32 codes; lut (R, C) f64 log LUT with the 0.0
    none row last; msk (B, S) bool; cmask: C bools marking the mixture
    channels; gsel: the 3 singlet channels. tail: None (dense holds every
    lane) or the v2 wire's deep-lane tail (tpos, tcode), (B, K2p) int32,
    positions slot * n_deep + the lane past U0, sorted per cell; n_deep:
    the deep lanes U - U0. Returns (t (C, B, S), gl (3, B, S)) f64."""
    if dense.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import front_exact as kernel

        return kernel.front_exact(dense, lut, msk, cmask, gsel, tail, n_deep)
    if dense.device.type != "cpu":
        raise ValueError(f"front_exact: unsupported device {dense.device}")
    return front_exact_plain(dense, lut, msk, cmask, gsel, tail, n_deep)


def front_exact_plain(dense, lut, msk, cmask, gsel, tail=None, n_deep=0):
    """The plain PyTorch version of K2': the full lanes (rebuilt from the
    tail, if any), a gather-sum over lanes in lane order, then the same
    normalisations, processed in cell chunks."""
    R, C = lut.shape
    codes = dense if tail is None else rebuild_lanes(dense, *tail, n_deep,
                                                     R - 1)
    B, S, U = codes.shape
    cm = torch.as_tensor(list(cmask), dtype=torch.bool, device=lut.device)
    gs = torch.as_tensor(list(gsel), dtype=torch.int64, device=lut.device)
    neutral = torch.tensor([1.0, 0.0, 0.0], dtype=lut.dtype,
                           device=lut.device).view(3, 1, 1)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(S * max(C, U), 1))
    ts, gls = [lut.new_zeros((C, 0, S))], [lut.new_zeros((3, 0, S))]
    for b0 in range(0, B, step):
        c = codes[b0 : b0 + step].to(torch.int64).clamp(0, R - 1)
        lograw = lut.new_zeros(c.shape[:2] + (C,))
        for u in range(U):
            lograw = lograw + lut[c[..., u]]
        lograw = lograw.permute(2, 0, 1)  # (C, b, S)
        mx = torch.amax(lograw[cm], dim=0)
        ts.append((torch.exp(lograw - mx) + 1e-6) / _TMAX)
        ls = lograw.index_select(0, gs)
        e = torch.exp(ls - torch.amax(ls, dim=0))
        q = e / ((e[0] + e[1]) + e[2]) + 1e-6
        q = q / ((q[0] + q[1]) + q[2])
        gls.append(torch.where(msk[b0 : b0 + step], q, neutral))
    return torch.cat(ts, dim=1), torch.cat(gls, dim=1)


def exact_front(codes, idx, msk, lut, cmask, gsel, wire=None,
                front_fn=front_exact):
    """The front half of the exact block step: the shipped block (any form
    of ``ops/wire.py``) decoded and run through the front. A v2 wire is
    decoded into its parts, which the front reads as they are (the
    deep-lane tail is not rebuilt into lanes, as the JAX package does); the
    v1 and explicit forms are full-lane codes. Returns (t (C, B, S), gl
    (3, B, S), idx (B, S), msk (B, S))."""
    tail, n_deep = None, 0
    if wire is not None and wire[0] == "w2":
        dense, tail, idx, msk = unpack_wire_v2(codes, wire, parts=True)
        if tail is not None:
            tail = tuple(x.to(torch.int32).contiguous() for x in tail)
            n_deep = wire[2] - wire[3]
    else:
        dense, idx, msk = unpack_block_inputs(codes, idx, msk, wire)
    t, gl = front_fn(dense.to(torch.int32).contiguous(), lut,
                     msk.contiguous(), cmask, gsel, tail, n_deep)
    return t, gl, idx, msk


def exact_pair(t, gl, idx, msk, g_table, expand, n_alpha, n_samples,
               a0_sep=False, sym_a=None, pair_fn=pair_exact):
    """The pair half of the exact block step: the g gather and the pair
    search with the singlet term on ``exact_front``'s outputs. Returns
    (llk (B, V), llk0 (B,), llk_ab (B, V, V, A), llk_00 (B, A)) f64."""
    _, B, S = t.shape
    NS = g_table.shape[1] - 1
    idx_n = torch.where(msk, idx, NS).reshape(-1)
    # gathered straight into the channel-leading layout the kernel reads
    g = g_table.index_select(1, idx_n).view(-1, B, S)
    llk_ab, llk_00, llk, llk0 = pair_fn(t, g, gl, n_samples, n_alpha,
                                        a0_sep, sym_a, expand)
    return llk, llk0, llk_ab, llk_00


def exact_block(codes, idx, msk, g_table, lut, cmask, gsel, expand,
                n_alpha, n_samples, a0_sep=False, sym_a=None, wire=None,
                front_fn=front_exact, pair_fn=pair_exact, acct=None):
    """Fused exact-mode block step: ``exact_front`` then ``exact_pair``,
    the latter the span dispatch.pair (``utils/spans``; acct: the
    engine's ``phase_s``, or None for the trace alone).

    codes/idx/msk/wire: any shipped block form (``ops/wire.py``).
    g_table (3V+3, NS+1) f64: the gps rows, the three gp0 rows, and the
    neutral column at index NS that masked slots gather. lut/cmask/gsel/
    expand: the exact tables (``models/engine.exact_tables_from_numpy``).
    front_fn and pair_fn are K2' and K3' (or, for a check, their plain
    versions).

    Returns (llk (B, V), llk0 (B,), llk_ab (B, V, V, A), llk_00 (B, A))
    f64."""
    t, gl, idx, msk = exact_front(codes, idx, msk, lut, cmask, gsel, wire,
                                  front_fn)
    with span("dispatch.pair", acct):
        return exact_pair(t, gl, idx, msk, g_table, expand, n_alpha,
                          n_samples, a0_sep, sym_a, pair_fn)
