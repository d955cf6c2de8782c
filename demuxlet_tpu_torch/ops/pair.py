"""Fast-mode pair search: dispatch to the Hopper kernels and their plain
PyTorch versions (port of ``demuxlet_tpu/ops/pallas_pair.py``:
``dedup_channels`` :48, ``_SMOOTH``/``_KNORM``/``_norm_t`` :78-93,
``extend_luts`` :1190 and ``_call_pair_kernel`` :297). Pools with
``V*V*A <= 384`` take the unrolled K1; larger pools the tiled K5' + K4'
(``ops/pair_tiled.py``).

Per (cell, slot) with g = genotype posteriors (V, 3) and t the mixture
table (A, 3, 3):
    U[j,a,m]     = sum_l g[j,l] * t[a,l,m]
    inner[j,k,a] = sum_m g[k,m] * U[j,a,m]
llk_ab[j,k,a] sums log(inner) over slots; llk_00[a] is the same with
j = k = g0: on the unrolled route the f32 mean of g over samples in j
order, taken in the kernel; on the tiled route the rows the caller gives
(the front's host gp0), else that same mean. a0_sep: the alpha == 0 plane
is separable, llk_ab[j,k,0] = sum log d[j] + sum log gsum[k]. sym_a: the
alpha == 0.5 plane is (j,k)-symmetric and its j > k channels are copies
of (k, j), so ties resolve as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

UNROLL_CAP = 384  # pallas_pair._UNROLL_CAP: max V*V*A of the unrolled K1/K3'

# exact-neutrality constants, computed in numpy f32 exactly as the JAX
# package does: with q = fl(1 + 1e-6), fl(q * fl(1/q)) == 1.0, so a padded
# slot (lograw == 0) yields t == 1 exactly and adds log(1) == 0
_SMOOTH = np.float32(1e-6)
_KNORM = np.float32(1.0) / (np.float32(1.0) + np.float32(1e-6))

# the plain version's (V, V, A, cells, S) intermediate stays under this many
# floats (512 MB) by chunking the cell axis, which leaves every sum unchanged
_PLAIN_CHUNK_ELEMS = 1 << 27


def unrolled(V, A):
    """Whether a pool of V samples and A alphas takes the unrolled kernels
    (K1 in fast mode, K3' in exact mode when its stages hold the pool);
    larger pools take the tiled K5' + K4' or K7' + K6'."""
    return V * V * A <= UNROLL_CAP


def dedup_channels(grid_alpha):
    """(cols, expand) for the A*9 mixture columns: the per-UMI factor
    depends on (a, l, m) only through p = 0.5*l + (m-l)*0.5*alpha, so
    columns with equal p are identical. cols: first-occurrence A*9
    indices of the unique columns; expand: per-logical-channel index into
    the deduplicated table."""
    seen, cols, expand = {}, [], []
    for a, alpha in enumerate(grid_alpha):
        for l in range(3):
            for m in range(3):
                p = 0.5 * l + (m - l) * 0.5 * alpha
                if p not in seen:
                    seen[p] = len(cols)
                    cols.append(a * 9 + l * 3 + m)
                expand.append(seen[p])
    return tuple(cols), tuple(expand)


def extend_luts(w, logf):
    """Append the zero 'none' row that padding and markers select."""
    w_ext = np.zeros((w.shape[0] + 1, w.shape[1]), dtype=np.float32)
    w_ext[:-1] = w
    logf_ext = np.zeros((logf.shape[0] + 1, 3), dtype=np.float32)
    logf_ext[:-1] = logf
    return w_ext, logf_ext


def norm_t(lograw: torch.Tensor, dim: int) -> torch.Tensor:
    """Mixture table t = (exp(lr - max) + 1e-6) / (1 + 1e-6); the final
    division is the constant because max(exp(lr - max)) == 1."""
    mx = torch.amax(lograw, dim=dim, keepdim=True)
    return (torch.exp(lograw - mx) + float(_SMOOTH)) * float(_KNORM)


def pair_llks(t, gps_t, V, A, a0_sep=False, sym_a=None, expand=None,
              gp0_t=None):
    """Pair-search LLKs.

    t (C, B, S) f32: deduplicated mixture table (``expand`` maps the A*9
    logical channels onto its C rows; None means C == A*9 in order).
    gps_t (3V, B, S) f32, (j, l) major; padded slots carry (1, 0, 0).
    gp0_t (3, B, S) f32: the background rows of the tiled route (None:
    ``_background_rows``); the unrolled route ignores it, as the JAX
    package does. Returns (llk_ab (B, V, V, A), llk_00 (B, A)) f32.

    A CUDA tensor launches K1 (``kernels/pair_fast.py``), or K5' and K4'
    when V*V*A > 384; a CPU tensor runs their plain versions. Nothing
    falls back from one to the other."""
    if expand is None:
        expand = tuple(range(A * 9))
    if not unrolled(V, A):
        # imported here: pair_tiled imports this module
        from demuxlet_tpu_torch.ops import pair_tiled as PT

        return PT.pair_fast_tiled(t, gps_t, _gp0(gps_t, gp0_t, V), V, A,
                                  a0_sep, sym_a, expand)
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import pair_fast

        return pair_fast.pair_fast(t, gps_t, V, A, a0_sep, sym_a, expand)
    if t.device.type != "cpu":
        raise ValueError(f"pair_llks: unsupported device {t.device}")
    return pair_llks_plain(t, gps_t, V, A, a0_sep, sym_a, expand)


def _background_rows(g, V):
    """g0 = f32 mean over samples, summed in j order (the kernel's order)."""
    s = g[0]
    for j in range(1, V):
        s = s + g[j]
    return s * float(np.float32(1.0 / V))


def _gp0(gps_t, gp0_t, V):
    """The tiled route's background rows: gp0_t, or without it the f32
    sample mean (``_call_pair_kernel`` :315-319)."""
    if gp0_t is not None:
        return gp0_t
    _, B, S = gps_t.shape
    return _background_rows(gps_t.view(V, 3, B, S), V).contiguous()


def pair_llks_plain(t, gps_t, V, A, a0_sep=False, sym_a=None, expand=None,
                    gp0_t=None):
    """The plain PyTorch version of K1: the same math as einsums, the same
    ``expand``, ``a0_sep``, ``sym_a`` mirroring and ``g0`` order,
    processed in cell chunks (``_PLAIN_CHUNK_ELEMS``); when V*V*A > 384,
    the plain versions of K5' and K4' with ``pair_llks``' background
    rows."""
    if expand is None:
        expand = tuple(range(A * 9))
    if not unrolled(V, A):
        from demuxlet_tpu_torch.ops import pair_tiled as PT

        return PT.pair_fast_tiled(
            t, gps_t, _gp0(gps_t, gp0_t, V), V, A, a0_sep, sym_a, expand,
            pair_fn=PT.pair_tiled_plain, extras_fn=PT.extras_fast_plain)
    _, B, S = t.shape
    step = max(1, _PLAIN_CHUNK_ELEMS // max(V * V * A * S, 1))
    ex = torch.as_tensor(expand, dtype=torch.int64, device=t.device)
    parts_ab, parts_00 = [], []
    for b0 in range(0, B, step):
        tx = t[:, b0 : b0 + step].index_select(0, ex)
        ab, z0 = _pair_plain_chunk(
            tx.reshape(A, 3, 3, -1, S),
            gps_t[:, b0 : b0 + step].reshape(V, 3, -1, S),
            V, A, a0_sep, sym_a,
        )
        parts_ab.append(ab)
        parts_00.append(z0)
    return torch.cat(parts_ab, dim=0), torch.cat(parts_00, dim=0)


def _pair_plain_chunk(tx, g, V, A, a0_sep, sym_a, g0=None):
    """tx (A, 3, 3, b, S) expanded table, g (V, 3, b, S); g0 (3, b, S)
    the background rows, None for the f32 sample mean (K1's)."""
    U = torch.einsum("jlbs,almbs->jambs", g, tx)
    inner = torch.einsum("kmbs,jambs->jkabs", g, U)
    llk_ab = torch.log(inner).sum(dim=-1)  # (j, k, a, b)
    if g0 is None:
        g0 = _background_rows(g, V)  # (3, b, S)
    U0 = torch.einsum("lbs,almbs->ambs", g0, tx)
    inner0 = torch.einsum("mbs,ambs->abs", g0, U0)
    llk_00 = torch.log(inner0).sum(dim=-1)  # (a, b)
    if a0_sep:
        t0 = tx[0, :, 0]  # (3, b, S): t[0, l, 0] for l = 0, 1, 2
        d = torch.einsum("jlbs,lbs->jbs", g, t0)
        sd = torch.log(d).sum(dim=-1)  # (j, b)
        sg = torch.log(g.sum(dim=1)).sum(dim=-1)  # (k, b)
        llk_ab[:, :, 0] = sd[:, None] + sg[None, :]
        d0 = torch.einsum("lbs,lbs->bs", g0, t0)
        llk_00[0] = (torch.log(d0).sum(dim=-1)
                     + torch.log(g0.sum(dim=0)).sum(dim=-1))
    if sym_a is not None:
        plane = llk_ab[:, :, sym_a]
        lower = torch.tril(torch.ones(V, V, dtype=torch.bool,
                                      device=plane.device), diagonal=-1)
        llk_ab[:, :, sym_a] = torch.where(
            lower[:, :, None], plane.transpose(0, 1), plane)
    return llk_ab.permute(3, 0, 1, 2).contiguous(), llk_00.T.contiguous()
