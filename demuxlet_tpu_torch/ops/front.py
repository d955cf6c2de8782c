"""Fused fast-mode block step: decoded block -> (llk, llk0, llk_ab, llk_00)
(port of ``demuxlet_tpu/ops/pallas_pair.py::demux_block_fast_impl``
:1028-1180).

Plain PyTorch around the pair kernel, as the JAX package left this part
to XLA:

* counts: one (R+1, B*S) f32 count table per block, filled by
  ``scatter_add_`` of 1.0 from the dense UMI lanes and from the v2 wire's
  deep-lane tail, both parts of ``ops/wire.decode`` (row R is a trash row
  for dropped tail entries, so no index leaves the tensor). Adding 1.0s in f32 is exact in any order, so
  the counts equal the JAX one-hot counts bit for bit;
* the LUT contraction ``lograw = [w_ext | logf_ext].T @ counts`` with TF32
  off (``utils/device.py``), channel-leading like the JAX front; the
  matmul may sum the R rows in another order than XLA (last-bit
  differences in lograw, well inside the 1e-5 relative front tolerance);
* ``norm_t`` and the pass-1 GL table: with the two above, the front
  (``front_half``, the span dispatch.front);
* the gps/gp0 gather (channel-leading rows of the (3V+3, NS+1) table
  ``fast_g_table``, whose neutral column NS masked slots read; the engine
  builds the table once per table set), the pair search
  (``ops/pair.pair_llks``: K1, or K5' + K4' with the gathered gp0 rows on
  pools with V*V*A > 384) and the singlet contraction (``pair_half``, the
  span dispatch.pair).
"""

from __future__ import annotations

import torch

from demuxlet_tpu_torch.ops.pair import norm_t, pair_llks
from demuxlet_tpu_torch.utils.spans import span


def _counts(c, R):
    """(B, S, U) LUT rows in [0, R) -> (R+1, B*S) f32 counts (row R empty
    until tail scatters use it as trash)."""
    B, S, U = c.shape
    BS = B * S
    pos = torch.arange(BS, device=c.device).view(B, S, 1)
    flat = (c.to(torch.int64) * BS + pos).reshape(-1)
    cnt = torch.zeros((R + 1) * BS, dtype=torch.float32, device=c.device)
    cnt.scatter_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    return cnt


def fast_g_table(gps_table, gp0_table):
    """(3V+3, NS+1) f32, channel-leading: the gps (j, l) rows, the three
    gp0 rows, and the neutral column NS ((1, 0, 0) for every sample and
    gp0) that masked slots gather. gps_table (NS, V, 3), gp0_table (NS,
    3)."""
    NS, V, _ = gps_table.shape
    neutral = torch.zeros((1, V * 3 + 3), dtype=torch.float32,
                          device=gps_table.device)
    neutral[0, 0 : V * 3 : 3] = 1.0
    neutral[0, V * 3] = 1.0
    return torch.cat(
        [torch.cat([gps_table.reshape(NS, V * 3), gp0_table], dim=1),
         neutral], dim=0,
    ).T.contiguous()


def front_entries(parts):
    """The entries ``front_half`` scatters into a decoded block's count
    table: every dense lane and every deep-lane tail entry, pads
    included."""
    n = parts.dense.numel()
    return n if parts.tail is None else n + parts.tail[0].numel()


def front_half(parts, tab):
    """The front of the fast block step on a decoded block
    (``ops/wire.Parts``) with the engine's ``DeviceTables`` tab: the count
    table, the LUT contraction, ``norm_t`` and the pass-1 GL table.
    Returns (t_x (C, B, S), gl (3, B, S), idx (B, S), msk (B, S)), t_x and
    gl f32."""
    R, C = tab.w_ext.shape
    none_row = R - 1
    dense, tail, n_deep, idx, msk = parts
    B, S, _ = dense.shape
    # the dense lanes count directly; deep-lane tail entries add into the
    # same table instead of being rebuilt into lanes
    cnt = _counts(dense.clamp(max=none_row), R)
    if tail is not None:
        tpos, tcode = tail
        tslot = tpos // n_deep
        # pad entries carry tcode == none (row R) and tslot >= S
        keep = (tcode < R) & (tslot < S)
        b = torch.arange(B, device=tpos.device).view(B, 1)
        flat = torch.where(
            keep,
            tcode.to(torch.int64) * (B * S) + b * S + tslot,
            R * B * S,
        ).reshape(-1)
        cnt.scatter_add_(0, flat, torch.ones_like(flat,
                                                  dtype=torch.float32))
    wl = torch.cat([tab.w_ext, tab.logf_ext], dim=1)  # (R, C + 3)
    lograw = torch.matmul(wl.T, cnt.view(R + 1, B * S)[:R])
    lograw = lograw.view(C + 3, B, S)
    t_x = norm_t(lograw[:C], 0)  # (C, B, S)

    # pass-1 GL table (cmd_cram_demuxlet.cpp:428-452), channel-leading
    ls = lograw[C:]
    gl = torch.exp(ls - torch.amax(ls, dim=0, keepdim=True))
    gl = gl / gl.sum(dim=0, keepdim=True)
    gl = gl + 1e-6
    gl = gl / gl.sum(dim=0, keepdim=True)
    neutral3 = torch.zeros((3, 1, 1), dtype=gl.dtype, device=gl.device)
    neutral3[0] = 1.0
    gl = torch.where(msk[None], gl, neutral3)  # masked slots: exact log 0
    return t_x, gl, idx, msk


def pair_half(t_x, gl, idx, msk, tab, n_alpha, n_samples, a0_sep=False,
              sym_a=None, pair_fn=pair_llks):
    """The rest of the fast block step on ``front_half``'s outputs: the
    gps/gp0 gather from tab's g table, the pair search and the singlet
    contraction. Returns (llk (B, V), llk0 (B,), llk_ab (B, V, V, A),
    llk_00 (B, A)) f32."""
    V, A = n_samples, n_alpha
    _, B, S = t_x.shape
    # per-slot genotype posteriors + gp0 in one gather, straight into the
    # channel-leading layout the kernels read; masked slots read the
    # neutral column NS
    NS = tab.g_table.shape[1] - 1
    idx_n = torch.where(msk, idx, NS).reshape(-1)
    g_all = tab.g_table.index_select(1, idx_n).view(-1, B, S)  # (3V+3, B, S)
    gps_t = g_all[: V * 3]
    gp0_t = g_all[V * 3 :]

    # the tiled route (V*V*A > 384) takes gp0 for llk_00, as on the TPU
    llk_ab, llk_00 = pair_fn(t_x, gps_t, V, A, a0_sep, sym_a, tab.expand,
                             gp0_t)

    # singlet pass (:415-461): masked slots meet neutral rows, log 1 == 0
    g = gps_t.view(V, 3, B, S)
    contrib = torch.log(g[:, 0] * gl[0] + g[:, 1] * gl[1] + g[:, 2] * gl[2])
    llk = contrib.sum(dim=-1).T
    contrib0 = torch.log(torch.clamp(
        gp0_t[0] * gl[0] + gp0_t[1] * gl[1] + gp0_t[2] * gl[2], min=1e-30))
    llk0 = contrib0.sum(dim=-1)
    return llk, llk0, llk_ab, llk_00


def fast_front(parts, tab, n_alpha, n_samples, a0_sep=False, sym_a=None,
               pair_fn=pair_llks, acct=None):
    """The fast block step: ``front_half`` as the span dispatch.front,
    then ``pair_half`` as the span dispatch.pair (``utils/spans``; acct:
    the engine's ``phase_s``, or None for the trace alone).

    parts: a decoded block (``ops/wire.Parts``). tab: the engine's
    ``DeviceTables``: f32 gps and gp0, w_ext (R, C) the deduplicated pair
    LUT and logf_ext (R, 3) the singlet LUT, each with the zero none row
    last, their expand, and the g table (``fast_g_table``). pair_fn is the
    pair search; the engine always uses ``pair_llks``, a check may pass
    ``pair_llks_plain``.

    Returns (llk (B, V), llk0 (B,), llk_ab (B, V, V, A), llk_00 (B, A))
    f32."""
    with span("dispatch.front", acct):
        front = front_half(parts, tab)
    del parts  # the decoded lanes are not held through the pair search
    with span("dispatch.pair", acct):
        return pair_half(*front, tab, n_alpha, n_samples, a0_sep, sym_a,
                         pair_fn)
