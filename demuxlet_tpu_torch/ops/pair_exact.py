"""Exact-mode pair search and singlet term: dispatch to the Hopper kernel
K3' and its plain PyTorch version (port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_call_pair_kernel_df`` :445 on
the unrolled path, ``V*V*A <= 384``, computed in f64 instead of df32);
larger pools, and the few smaller ones whose t channels K3''s
shared-memory stages cannot hold (V=1 with 162 alphas or more), go to the
tiled K7' + K6' (``ops/pair_tiled.py``).

Per (cell, slot), with g the genotype posteriors (V, 3), g0 the host f64
background row (3,), t the mixture table (A, 3, 3) and gl the pass-1 GL
table (3,):
    inner[j,k,a] = sum_m g[k,m] * (sum_l g[j,l] * t[a,l,m])
    llk_ab[j,k,a] = sum over slots of log inner[j,k,a]; llk_00[a] the same
    with j = k = g0; llk[j] = sum log(gl . g[j]); llk0 = sum log(gl . g0).
a0_sep and sym_a as in ``ops/pair.py``: the separable alpha == 0 plane,
and the alpha == 0.5 plane's j > k channels as copies of (k, j).
"""

from __future__ import annotations

import torch

from demuxlet_tpu_torch.kernels.pair_exact import k3_fits
from demuxlet_tpu_torch.ops.pair import (
    _PLAIN_CHUNK_ELEMS,
    _pair_plain_chunk,
    unrolled,
)
from demuxlet_tpu_torch.ops.pair_tiled import _dot3, pair_exact_tiled


def takes_k3(V, A, C, a0_sep):
    """Whether ``pair_exact`` takes K3' (else K7' + K6') for V samples, A
    alphas and C t channels."""
    return unrolled(V, A) and k3_fits(V, A, C, a0_sep)


def pair_exact(t, g, gl, V, A, a0_sep=False, sym_a=None, expand=None):
    """Exact pair-search and singlet LLKs.

    t (C, B, S) f64: the front's mixture table (``expand`` maps the A*9
    logical channels onto its C rows; None means C == A*9 in order).
    g (3V+3, B, S) f64: genotype posteriors, (j, l) major, then the three
    background rows; gl (3, B, S) f64. Masked slots carry t == 1 and
    neutral (1, 0, 0) rows. Returns (llk_ab (B, V, V, A), llk_00 (B, A),
    llk (B, V), llk0 (B,)) f64.

    A CUDA tensor launches K3' (``kernels/pair_exact.py``); a CPU tensor
    runs ``pair_exact_plain``. Nothing falls back from one to the other.
    Pools with V*V*A > 384, and those whose C channels K3''s stages cannot
    hold (``k3_fits``), take ``pair_tiled.pair_exact_tiled`` (K7' and K6',
    or their plain versions) with the same contract, on either device."""
    if expand is None:
        expand = tuple(range(A * 9))
    if not takes_k3(V, A, t.shape[0], a0_sep):
        return pair_exact_tiled(t, g, gl, V, A, a0_sep, sym_a, expand,
                                force=unrolled(V, A))
    if t.device.type == "cuda":
        from demuxlet_tpu_torch.kernels import pair_exact as kernel

        return kernel.pair_exact(t, g, gl, V, A, a0_sep, sym_a, expand)
    if t.device.type != "cpu":
        raise ValueError(f"pair_exact: unsupported device {t.device}")
    return pair_exact_plain(t, g, gl, V, A, a0_sep, sym_a, expand)


def pair_exact_plain(t, g, gl, V, A, a0_sep=False, sym_a=None, expand=None):
    """The plain PyTorch version of K3': K1's plain einsums on f64 inputs
    with the given background rows, and the singlet sums, processed in
    cell chunks."""
    if expand is None:
        expand = tuple(range(A * 9))
    _, B, S = t.shape
    step = max(1, _PLAIN_CHUNK_ELEMS // max(V * V * A * S, 1))
    ex = torch.as_tensor(expand, dtype=torch.int64, device=t.device)
    parts = [(t.new_zeros((0, V, V, A)), t.new_zeros((0, A)),
              t.new_zeros((0, V)), t.new_zeros((0,)))]
    for b0 in range(0, B, step):
        sl = slice(b0, b0 + step)
        tx = t[:, sl].index_select(0, ex).reshape(A, 3, 3, -1, S)
        gj = g[: 3 * V, sl].reshape(V, 3, -1, S)
        g0 = g[3 * V :, sl]
        ab, z0 = _pair_plain_chunk(tx, gj, V, A, a0_sep, sym_a, g0=g0)
        q = gl[:, sl]
        llk = torch.log(_dot3(q, gj.transpose(0, 1))).sum(dim=-1).T
        llk0 = torch.log(_dot3(q, g0)).sum(dim=-1)
        parts.append((ab, z0, llk.contiguous(), llk0))
    return tuple(torch.cat(p, dim=0) for p in zip(*parts))
