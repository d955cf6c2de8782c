"""Pair search on large pools, V*V*A > 384, in both modes: the tile plan,
the tiled pair kernels and their O(V) companions with their plain PyTorch
versions, and the reassembly.

Exact mode (f64; port of ``demuxlet_tpu/ops/pallas_pair_exact.py``:
``plan_pair_tiles_df`` :524, ``_extras_slots`` :559,
``_call_pair_kernel_df_tiled`` :787 and the tiled branch of
``demux_block_exact_impl`` :1283-1315, with ``plan_groups`` :465 of
``ops/pallas_pair.py``): K7' (``pair_tiled``) and K6' (``extras``).
Fast mode (f32; port of ``ops/pallas_pair.py``: ``plan_pair_tiles`` :426,
``_call_extras_only`` :660 and ``_call_pair_kernel_tiled`` :712): K5'
(``pair_tiled_fast``) and K4' (``extras_fast``).

Per (cell, slot), with g_j the genotype row (3,), g0 the host background
row, t_a the mixture table (3, 3) and gl the pass-1 GL row:

* K7'/K5', for each (j, k) of a planned tile and each alpha of the tile's
  alpha list: ``llk_ab[j,k,a] = sum_s log(g_k . (g_j t_a))``;
* K6'/K4', the O(V) channels in ``extras_keys`` order: (K6' only) the
  singlets ``sum log(gl . g_j)`` (j = V: g0); with a separable alpha == 0
  plane ``log(g_j . t_0[:,0])``, ``log(sum g_k)``, ``u00`` and ``g0s``;
  and ``sum log(g0 . (g0 t_a))`` for every other alpha. Fast mode's
  singlets come from the fast front (``ops/front.py``).

The TPU's tile extents came from its VMEM budget and padded V with neutral
samples. On Hopper the extent is a compile-time register count (8 or 16)
and the kernel guards the ragged edge (j, k < V). The symmetric
alpha == 0.5 plane runs apart from the other alphas on upper-triangle
tiles only (diagonal tiles skip k < j) and its (k, j) channels are exact
copies of (j, k), on every grid and in both modes. That is the TPU's
default exact plan; its fast plan keeps the plane with the other alphas on
multi-alpha grids (``plan_groups(..., default=False)``), where (j, k) and
(k, j) then differ by ulps, because a second ``pallas_call`` re-streamed
the t and g blocks (``pallas_pair.py:476-482``). Here the split costs
nothing, so fast mode keeps K1's exact symmetry. The kernels write
straight into (B, V, V, A) and mirror there, so the TPU's position-map
gather (``tile_pos_map``) is not needed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from demuxlet_tpu_torch.ops.pair import (
    _PLAIN_CHUNK_ELEMS,
    UNROLL_CAP,
    unrolled,
)


@dataclass(frozen=True)
class TilePlan:
    """The work of one cell as K7' blocks.

    tile: Jt = Kt, the tile extent on both sample axes (8 or 16).
    alist: the alpha indices K7' computes (the non-separable ones; the
        symmetric plane, if any, last).
    items: one (j0, k0, a_begin, a_count, sym) per CUDA block of a cell:
        the tile's first j and k, its slice of ``alist``, and whether it
        is the symmetric plane's upper-triangle tile (skip k < j, mirror
        k > j).
    """

    tile: int
    alist: tuple
    items: tuple


def plan_tiles(V, A, a0_sep, sym_a, force=False) -> Optional[TilePlan]:
    """The tile plan of a pool, or None when the unrolled K3' takes it
    (V*V*A <= 384) and ``force`` is not set. force: plan such a pool all
    the same (the shapes K3''s stages refuse, ``ops/pair_exact.py``). The
    tile extent is 16 for V > 8, else 8."""
    if unrolled(V, A) and not force:
        return None
    tile = 16 if V > 8 else 8
    n_t = -(-V // tile)
    ac = [a for a in range(A) if not (a0_sep and a == 0)]
    sym = [sym_a] if sym_a is not None and sym_a in ac else []
    others = [a for a in ac if a not in sym]
    items = []
    if others:
        items += [(jt * tile, kt * tile, 0, len(others), 0)
                  for jt in range(n_t) for kt in range(n_t)]
    if sym:
        items += [(jt * tile, kt * tile, len(others), 1, 1)
                  for jt in range(n_t) for kt in range(jt, n_t)]
    return TilePlan(tile, tuple(others + sym), tuple(items))


def extras_keys(V, A, a0_sep, singlets=True):
    """K6''s output columns in order (``_extras_slots``' key scheme):
    ('s', j) for j <= V (V: g0), then with a0_sep ('d', j), ('gs', k),
    ('u00',), ('g0s',), then ('m0', a) for every non-separable alpha.
    singlets=False: K4''s columns, the same without the ('s', j)."""
    keys = [("s", j) for j in range(V + 1)] if singlets else []
    if a0_sep:
        keys += [("d", j) for j in range(V)]
        keys += [("gs", k) for k in range(V)]
        keys += [("u00",), ("g0s",)]
    keys += [("m0", a) for a in range(A) if not (a0_sep and a == 0)]
    return keys


def pair_tiled(t, g, V, A, plan, expand):
    """K7': the tiled alphas of llk_ab (B, V, V, A) f64; the separable
    alpha == 0 plane, when there is one, is left 0. t (C, B, S) and g
    (3V+3, B, S) f64 as ``pair_exact`` takes them. A CUDA tensor launches
    the kernel (``kernels/pair_tiled_exact.py``), a CPU tensor runs
    ``pair_tiled_plain``; nothing falls back."""
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import pair_tiled_exact as kernel

        return kernel.pair_tiled(t, g, V, A, plan, expand)
    if t.device.type != "cpu":
        raise ValueError(f"pair_tiled: unsupported device {t.device}")
    return pair_tiled_plain(t, g, V, A, plan, expand)


def pair_tiled_fast(t, gps_t, V, A, plan, expand):
    """K5': ``pair_tiled`` in f32 for fast mode. t (C, B, S) and gps_t
    (3V, B, S) f32 as ``ops/pair.pair_llks`` takes them. A CUDA tensor
    launches the kernel (``kernels/pair_tiled_fast.py``), a CPU tensor runs
    ``pair_tiled_plain``; nothing falls back."""
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import pair_tiled_fast as kernel

        return kernel.pair_tiled_fast(t, gps_t, V, A, plan, expand)
    if t.device.type != "cpu":
        raise ValueError(f"pair_tiled_fast: unsupported device {t.device}")
    return pair_tiled_plain(t, gps_t, V, A, plan, expand)


def pair_tiled_plain(t, g, V, A, plan, expand):
    """The plain PyTorch version of K7' and K5', in the dtype of t: every
    (j, k) of the planned alphas by einsums over cell chunks, then the
    symmetric plane's j > k channels copied from (k, j). g: the 3V
    genotype rows, optionally followed by rows it does not read."""
    _, B, S = t.shape
    out = t.new_zeros((B, V, V, A))
    al = list(plan.alist)
    if not al:
        return out
    nA = len(al)
    ex = torch.as_tensor([expand[a * 9 + i] for a in al for i in range(9)],
                         dtype=torch.int64, device=t.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(V * V * nA * S, 1))
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        tx = t[:, sl].index_select(0, ex).reshape(nA, 3, 3, -1, S)
        gj = g[: 3 * V, sl].reshape(V, 3, -1, S)
        U = torch.einsum("jlbs,almbs->jambs", gj, tx)
        inner = torch.einsum("kmbs,jambs->jkabs", gj, U)
        out[sl, :, :, al] = torch.log(inner).sum(dim=-1).permute(3, 0, 1, 2)
    if any(it[4] for it in plan.items):
        a = al[-1]
        plane = out[..., a]
        lower = torch.tril(torch.ones(V, V, dtype=torch.bool,
                                      device=t.device), diagonal=-1)
        out[..., a] = torch.where(lower, plane.transpose(1, 2), plane)
    return out


def extras(t, g, gl, V, A, a0_sep, expand):
    """K6': the O(V) channels (B, len(extras_keys)) f64. A CUDA tensor
    launches the kernel (``kernels/extras_exact.py``), a CPU tensor runs
    ``extras_plain``; nothing falls back."""
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import extras_exact as kernel

        return kernel.extras(t, g, gl, V, A, a0_sep, expand)
    if t.device.type != "cpu":
        raise ValueError(f"extras: unsupported device {t.device}")
    return extras_plain(t, g, gl, V, A, a0_sep, expand)


def extras_fast(t, gps_t, gp0_t, V, A, a0_sep, expand):
    """K4': the O(V) channels of fast mode, (B, len(extras_keys(...,
    singlets=False))) f32. t (C, B, S), gps_t (3V, B, S) and gp0_t (3, B,
    S), the host background rows, f32. A CUDA tensor launches the kernel
    (``kernels/extras_fast.py``), a CPU tensor runs ``extras_fast_plain``;
    nothing falls back."""
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import extras_fast as kernel

        return kernel.extras_fast(t, gps_t, gp0_t, V, A, a0_sep, expand)
    if t.device.type != "cpu":
        raise ValueError(f"extras_fast: unsupported device {t.device}")
    return extras_fast_plain(t, gps_t, gp0_t, V, A, a0_sep, expand)


def extras_fast_plain(t, gps_t, gp0_t, V, A, a0_sep, expand):
    """The plain PyTorch version of K4': ``extras_plain`` without the
    singlet columns, its background rows given apart."""
    return extras_plain(t, gps_t, None, V, A, a0_sep, expand, g0=gp0_t)


def _dot3(q, r):
    """q[0]*r[0] + q[1]*r[1] + q[2]*r[2] over the leading axis, in order."""
    return q[0] * r[0] + q[1] * r[1] + q[2] * r[2]


def extras_plain(t, g, gl, V, A, a0_sep, expand, g0=None):
    """The plain PyTorch version of K6', column by column group, in the
    dtype of t. g0: the background rows, None for rows 3V.. of g.
    gl None: no singlet columns (K4')."""
    gj = g[: 3 * V].reshape(V, 3, *g.shape[1:]).transpose(0, 1)  # (3, V, B, S)
    if g0 is None:
        g0 = g[3 * V :]
    tx = lambda a, l, m: t[expand[a * 9 + l * 3 + m]]
    cols = []
    if gl is not None:
        cols += [torch.log(_dot3(gl[:, None], gj)).sum(dim=-1).T,
                 torch.log(_dot3(gl, g0)).sum(dim=-1)[:, None]]
    if a0_sep:
        t0 = torch.stack([tx(0, l, 0) for l in range(3)])
        cols += [torch.log(_dot3(t0[:, None], gj)).sum(dim=-1).T,
                 torch.log(gj[0] + gj[1] + gj[2]).sum(dim=-1).T,
                 torch.log(_dot3(t0, g0)).sum(dim=-1)[:, None],
                 torch.log(g0[0] + g0[1] + g0[2]).sum(dim=-1)[:, None]]
    for a in range(A):
        if a0_sep and a == 0:
            continue
        u = [g0[0] * tx(a, 0, m) + g0[1] * tx(a, 1, m) + g0[2] * tx(a, 2, m)
             for m in range(3)]
        cols.append(torch.log(_dot3(g0, u)).sum(dim=-1)[:, None])
    return torch.cat(cols, dim=1).contiguous()


def _reassemble(llk_ab, ex, V, a0_sep):
    """(llk_ab, llk_00) from the tiled channels and the O(V) columns after
    the singlets: llk_ab[j,k,0] = logD[j] + logG[k] and llk_00[0] = u00 +
    g0s on a separable alpha == 0 plane, llk_00[a] = m0[a] otherwise."""
    if not a0_sep:
        return llk_ab, ex.contiguous()
    logd, logg = ex[:, :V], ex[:, V : 2 * V]
    llk_ab[..., 0] = logd[:, :, None] + logg[:, None, :]
    z00 = ex[:, 2 * V] + ex[:, 2 * V + 1]
    return llk_ab, torch.cat([z00[:, None], ex[:, 2 * V + 2 :]], dim=1)


def _tiled_plan(V, A, a0_sep, sym_a, first, force=False):
    plan = plan_tiles(V, A, a0_sep, sym_a, force)
    if plan is None:
        raise ValueError(f"V*V*A = {V * V * A} <= {UNROLL_CAP}: the "
                         f"unrolled {first} takes this pool")
    return plan


def pair_exact_tiled(t, g, gl, V, A, a0_sep=False, sym_a=None, expand=None,
                     pair_fn=pair_tiled, extras_fn=extras, force=False):
    """The tiled exact pair search and singlet term, with
    ``pair_exact``'s contract: (llk_ab (B, V, V, A), llk_00 (B, A), llk
    (B, V), llk0 (B,)) f64. K7' (when some alpha is not separable) and K6'
    on a CUDA tensor, their plain versions on a CPU tensor (pair_fn and
    extras_fn: for a check, the plain versions on any device); then the
    reassembly (``_reassemble``). force: take a pool of V*V*A <= 384 too
    (``plan_tiles``)."""
    if expand is None:
        expand = tuple(range(A * 9))
    plan = _tiled_plan(V, A, a0_sep, sym_a, "K3'", force)
    _, B, _ = t.shape
    if plan.items:
        llk_ab = pair_fn(t, g, V, A, plan, expand)
    else:  # a single-point alpha == 0 grid: K6' carries everything
        llk_ab = t.new_zeros((B, V, V, A))
    ex = extras_fn(t, g, gl, V, A, a0_sep, expand)
    llk_ab, llk_00 = _reassemble(llk_ab, ex[:, V + 1 :], V, a0_sep)
    return llk_ab, llk_00, ex[:, :V].contiguous(), ex[:, V].contiguous()


def pair_fast_tiled(t, gps_t, gp0_t, V, A, a0_sep=False, sym_a=None,
                    expand=None, pair_fn=pair_tiled_fast,
                    extras_fn=extras_fast):
    """The tiled fast pair search, with ``ops/pair.pair_llks``' contract:
    (llk_ab (B, V, V, A), llk_00 (B, A)) f32. gp0_t (3, B, S): the
    background rows of llk_00 (the front's host gp0, as the TPU's tiled
    path takes them). K5' (when some alpha is not separable) and K4' on a
    CUDA tensor, their plain versions on a CPU tensor (pair_fn and
    extras_fn: for a check, the plain versions on any device); then the
    reassembly (``_reassemble``)."""
    if expand is None:
        expand = tuple(range(A * 9))
    plan = _tiled_plan(V, A, a0_sep, sym_a, "K1")
    _, B, _ = t.shape
    if plan.items:
        llk_ab = pair_fn(t, gps_t, V, A, plan, expand)
    else:  # a single-point alpha == 0 grid: K4' carries everything
        llk_ab = t.new_zeros((B, V, V, A))
    ex = extras_fn(t, gps_t, gp0_t, V, A, a0_sep, expand)
    return _reassemble(llk_ab, ex, V, a0_sep)
