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

The lanes come as a decoded block's parts (``ops/wire.decode``): the
dense lanes and the wire v2's sorted deep-lane tail, summed without
rebuilding the full lanes; the v1 forms' full-lane codes are the case
with no tail.

``front_exact`` dispatches to the Hopper kernel K2' on a CUDA tensor and
to ``front_exact_plain`` on a CPU tensor; nothing falls back.
"""

from __future__ import annotations

import torch

from demuxlet_tpu_torch.ops.pair import _PLAIN_CHUNK_ELEMS
from demuxlet_tpu_torch.ops.pair_exact import pair_exact
from demuxlet_tpu_torch.ops.wire import rebuild_lanes
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


def exact_front(parts, tab, front_fn=front_exact):
    """The front half of the exact block step on a decoded block
    (``ops/wire.Parts``): its dense lanes and deep-lane tail as they are
    (the tail is not rebuilt into lanes, as the JAX package does) through
    the front, with the ``ExactTables`` tab's LUT. Returns (t (C, B, S),
    gl (3, B, S), idx (B, S), msk (B, S))."""
    dense, tail, n_deep, idx, msk = parts
    if tail is not None:
        tail = tuple(x.to(torch.int32).contiguous() for x in tail)
    t, gl = front_fn(dense.contiguous(), tab.lut, msk.contiguous(),
                     tab.cmask, tab.gsel, tail, n_deep)
    return t, gl, idx, msk


def exact_pair(t, gl, idx, msk, tab, n_alpha, n_samples, a0_sep=False,
               sym_a=None, pair_fn=pair_exact):
    """The pair half of the exact block step: the gather from the g table
    of tab (``ExactTables``) and the pair search with the singlet term on
    ``exact_front``'s outputs. Returns (llk (B, V), llk0 (B,), llk_ab (B,
    V, V, A), llk_00 (B, A)) f64."""
    _, B, S = t.shape
    NS = tab.g_table.shape[1] - 1
    idx_n = torch.where(msk, idx, NS).reshape(-1)
    # gathered straight into the channel-leading layout the kernel reads
    g = tab.g_table.index_select(1, idx_n).view(-1, B, S)
    llk_ab, llk_00, llk, llk0 = pair_fn(t, g, gl, n_samples, n_alpha,
                                        a0_sep, sym_a, tab.expand)
    return llk, llk0, llk_ab, llk_00


def exact_block(parts, tab, n_alpha, n_samples, a0_sep=False, sym_a=None,
                front_fn=front_exact, pair_fn=pair_exact, acct=None):
    """Fused exact-mode block step: ``exact_front`` then ``exact_pair``,
    the spans dispatch.front and dispatch.pair (``utils/spans``; acct:
    the engine's ``phase_s``, or None for the trace alone).

    parts: a decoded block (``ops/wire.Parts``). tab: the engine's
    ``ExactTables``: the (3V+3, NS+1) f64 g table (the gps rows, the three
    gp0 rows, and the neutral column at index NS that masked slots
    gather), the LUT and its cmask, gsel and expand. front_fn and pair_fn
    are K2' and K3' (or, for a check, their plain versions).

    Returns (llk (B, V), llk0 (B,), llk_ab (B, V, V, A), llk_00 (B, A))
    f64."""
    with span("dispatch.front", acct):
        front = exact_front(parts, tab, front_fn)
    del parts  # the decoded lanes are not held through the pair search
    with span("dispatch.pair", acct):
        return exact_pair(*front, tab, n_alpha, n_samples, a0_sep, sym_a,
                          pair_fn)
