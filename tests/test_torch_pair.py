"""Port pair search (demuxlet_tpu_torch/ops/pair.py): the plain PyTorch
version against the JAX Pallas kernel (interpret mode) and the JAX f64
likelihood path; the K1 CUDA kernel against the plain version on a card.

JAX is imported inside the tests that compare with it, so the ``cuda``
test also collects where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_pair.py``."""

import numpy as np
import pytest
import torch

from demuxlet_tpu.ops import luts
from demuxlet_tpu_torch.ops import pair as TP

torch.set_num_threads(2)


def _case(B, S, V, A, seed=0):
    """Slot counts, mask and posteriors as tests/test_pallas.py makes them."""
    rng = np.random.default_rng(seed)
    nb = 82
    cnt = rng.integers(0, 3, size=(B, S, nb)).astype(np.int32)
    msk = rng.random((B, S)) < 0.8
    cnt *= msk[:, :, None]
    gps = rng.dirichlet(np.ones(3), size=(B, S, V))
    gp0 = gps.mean(axis=2)
    grid = np.linspace(0, 0.5, A).tolist()
    w = luts.pair_lut(grid, 40)
    return cnt, msk, gps, gp0, w


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("B,S,V,A,opt", [
    (4, 64, 3, 2, False),
    (6, 100, 4, 3, False),
    (4, 200, 3, 2, True),
    (6, 100, 4, 3, True),
])
def test_plain_matches_jax_pallas_and_f64(B, S, V, A, opt):
    """pair_llks_plain vs JAX pair_llks_pallas(interpret=True): within
    1e-5 relative of the JAX f32 kernel, and within the fast-mode 2e-5
    of the JAX f64 path (relative, scale max(1, |x|))."""
    import jax.numpy as jnp

    from demuxlet_tpu.models.likelihood import pair_llks
    from demuxlet_tpu.ops.pallas_pair import pack_block, pair_llks_pallas

    cnt, msk, gps, gp0, w = _case(B, S, V, A)
    sym_a = A - 1 if opt and A > 1 else None
    ref_ab, ref_00 = pair_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
        jnp.asarray(gp0), jnp.asarray(w), A,
    )
    cnt_t, gps_t, wt = pack_block(cnt, msk, gps, w)
    jab, j00 = pair_llks_pallas(
        jnp.asarray(cnt_t), jnp.asarray(gps_t), jnp.asarray(wt), A, V,
        interpret=True, a0_sep=opt, sym_a=sym_a,
    )
    lograw = torch.einsum("nbs,nx->xbs", torch.from_numpy(cnt_t),
                          torch.from_numpy(wt))
    t = TP.norm_t(lograw, 0).contiguous()
    ab, z0 = TP.pair_llks(t, torch.from_numpy(gps_t), V, A, a0_sep=opt,
                          sym_a=sym_a)
    assert ab.shape == tuple(jab.shape) and z0.shape == tuple(j00.shape)
    assert _rel(ab, jab) < 1e-5
    assert _rel(z0, j00) < 1e-5
    assert _rel(ab.numpy()[:B], ref_ab) < 2e-5
    assert _rel(z0.numpy()[:B], ref_00) < 2e-5
    if sym_a is not None:  # mirrored channels are exact copies
        plane = ab[..., sym_a]
        assert torch.equal(plane, plane.transpose(1, 2))


@pytest.mark.parametrize("V", [3, 4, 8])
def test_padded_slots_are_exactly_neutral(V):
    """lograw == 0 gives t == 1 exactly, and a cell whose slots are all
    padded (t == 1, gps rows (1, 0, 0)) sums to exactly 0."""
    grid = np.linspace(0, 0.5, 5).tolist()
    cols, expand = TP.dedup_channels(grid)
    t = TP.norm_t(torch.zeros((len(cols), 2, 128)), 0)
    assert bool((t == 1.0).all())
    g = torch.zeros((3 * V, 2, 128))
    g[0::3] = 1.0
    for a0_sep, sym_a in ((False, None), (True, 4)):
        ab, z0 = TP.pair_llks(t, g, V, 5, a0_sep=a0_sep, sym_a=sym_a,
                              expand=expand)
        assert bool((ab == 0).all()) and bool((z0 == 0).all())


@pytest.mark.parametrize("grid", [
    [0.0, 0.5], np.linspace(0, 0.5, 5).tolist(), [0.0, 0.1, 0.2, 0.3, 0.5],
    [0.1, 0.3], [0.0],
])
def test_dedup_and_extend_luts_equal_jax(grid):
    from demuxlet_tpu.ops import pallas_pair as PP

    assert TP.dedup_channels(grid) == PP.dedup_channels(grid)
    w = luts.pair_lut(grid, 40)
    logf = luts.singlet_lut(40)
    for a, b in zip(TP.extend_luts(w, logf), PP.extend_luts(w, logf)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert TP._SMOOTH == PP._SMOOTH and TP._KNORM == PP._KNORM
    assert TP.UNROLL_CAP == PP._UNROLL_CAP


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 has no CPU mode)")
    return torch.device("cuda", 0)


def card_inputs(B, S, V, grid, device, edge=None, seed=3):
    """Fast pair-search inputs for a card test: t from random lograw with
    ~20% padded slots (t == 1), flat-Dirichlet g rows (3V, B, S) with
    neutral rows on padded slots, f32; then ``edge_inputs``' edge case in
    f32. Returns (t, g, expand, a0_sep, sym_a)."""
    from test_torch_exact import edge_inputs

    rng = np.random.default_rng(seed)
    cols, expand = TP.dedup_channels(grid)
    pad = rng.random((B, S)) < 0.2
    lograw = rng.normal(size=(len(cols), B, S)).astype(np.float32)
    lograw[:, pad] = 0.0
    t = TP.norm_t(torch.from_numpy(lograw).to(device), 0).contiguous()
    g = rng.dirichlet(np.ones(3), size=(V, B, S)).astype(np.float32)
    g[:, pad] = np.array([1.0, 0.0, 0.0], np.float32)
    g = torch.from_numpy(np.ascontiguousarray(
        g.transpose(0, 3, 1, 2).reshape(3 * V, B, S))).to(device)
    edge_inputs(edge, t, g, None, expand, rng)
    sym_a = grid.index(0.5) if 0.5 in grid else None
    return t, g, expand, grid[0] == 0.0, sym_a


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid,edge", [
    (64, 256, 8, np.linspace(0, 0.5, 5).tolist(), None),
    (40, 384, 8, [0.0, 0.5], None),
    (33, 200, 13, [0.0, 0.5], None),
    (32, 128, 3, [0.1, 0.3, 0.5], None),
    (16, 130, 2, [0.0], None),  # separable plane only; S not a warp multiple
    (8, 160, 19, [0.5], None),  # the V <= 20 instantiation, symmetric plane
    (8, 128, 1, [0.0, 0.25, 0.5], None),
    (4, 128, 2, np.linspace(0, 0.5, 96).tolist(), None),  # V*V*A == 384
    (2, 96, 1, np.linspace(0, 0.5, 384).tolist(), None),  # 24 rounds
    (4, 8192, 8, np.linspace(0, 0.5, 5).tolist(), None),  # deep
    # S neither a multiple of the 128-slot chunk nor of 4 (4-byte copies)
    (8, 1001, 8, np.linspace(0, 0.5, 5).tolist(), "floor"),
    (6, 200, 13, [0.0, 0.5], "floor"),
    (4, 256, 8, np.linspace(0, 0.5, 5).tolist(), "special"),
    (4, 130, 13, [0.0, 0.5], "special"),
    (4, 200, 8, np.linspace(0, 0.5, 5).tolist(), "padding"),
])
def test_k1_matches_plain_on_card(cuda_device, B, S, V, grid, edge):
    """K1 against pair_llks_plain on the card: 2e-5 relative (scale
    max(1, |x|); equal infinities and NaNs match), two launches give
    identical bits (no atomics), the alpha == 0.5 plane equals its
    transpose; exact-zero and NaN inner values give -inf and NaN, an
    all-padding block exact zeros."""
    from demuxlet_tpu_torch.kernels import pair_fast
    from test_torch_exact import assert_close_on_card

    A = len(grid)
    t, g, expand, a0_sep, sym_a = card_inputs(B, S, V, grid, cuda_device,
                                              edge)
    before = pair_fast.launches
    ab, z0 = TP.pair_llks(t, g, V, A, a0_sep, sym_a, expand)
    ab2, z02 = TP.pair_llks(t, g, V, A, a0_sep, sym_a, expand)
    torch.cuda.synchronize()
    assert pair_fast.launches == before + 2
    pab, pz0 = TP.pair_llks_plain(t, g, V, A, a0_sep, sym_a, expand)
    for x, y, z in ((ab, pab, ab2), (z0, pz0, z02)):
        assert_close_on_card(x, y, 2e-5, relative=True)
        assert torch.equal(x.nan_to_num(), z.nan_to_num())
        if edge == "padding":
            assert bool((x == 0).all())
    if sym_a is not None:
        plane = ab[..., sym_a].nan_to_num()
        assert torch.equal(plane, plane.transpose(1, 2))
    if edge == "special":
        assert bool(torch.isneginf(ab[0, 1, 1]).all()) and bool(
            torch.isnan(ab[1, :, :, A - 1]).all())
