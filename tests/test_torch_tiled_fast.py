"""Fast mode of the port on large pools (V*V*A > 384) against the JAX
package: the plain versions of K5' (tiled f32 pair search) and K4' (its
O(V) channels) through ``ops/pair.pair_llks`` against the JAX Pallas
kernels (interpret mode) and the JAX f64 likelihood path, the background
rows of each route, fast run_compact against the JAX engine's fast run()
and against the port's exact mode; and, on a card, K5' and K4' against
their plain versions and the port's dense likelihood kernels.

JAX is imported inside the tests that compare with it, so the ``cuda``
tests also collect where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_tiled_fast.py``.
"""

import numpy as np
import pytest
import torch

from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops import pair as TP
from demuxlet_tpu_torch.ops import pair_tiled as PT
from demuxlet_tpu_torch.ops.front import fast_front
from test_torch_exact import _likelihood_f64, _parts, _swap_equal, _workload
from test_torch_pair import _case, _rel

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 2e-5  # fast-mode contract, relative with scale max(1, |x|)


def _grid(A):
    return np.linspace(0.0, 0.5, A).tolist()


def _packed(B, S, V, A):
    """tests/test_pallas.py's block, packed as the Pallas kernels take it
    (B padded to 32 cells, S to 128 slots, neutral rows on padding), and
    the port's mixture table t from it."""
    from demuxlet_tpu.ops.pallas_pair import pack_block

    cnt, msk, gps, gp0, w = _case(B, S, V, A)
    cnt_t, gps_t, wt = pack_block(cnt, msk, gps, w)
    lograw = torch.einsum("nbs,nx->xbs", torch.from_numpy(cnt_t),
                          torch.from_numpy(wt))
    t = TP.norm_t(lograw, 0).contiguous()
    return (cnt, msk, gps, gp0, w), (cnt_t, gps_t, wt), t


# the tiled cases of tests/test_pallas.py (16: whole 16-tiles; 17 and 20: a
# ragged edge, which the JAX package pads with neutral samples; 20/1: the
# single-point alpha == 0 grid, no tile at all) and V=7/A=8 on one ragged
# 8-tile
CASES = [(4, 64, 16, 2, False), (4, 200, 17, 3, True), (4, 64, 32, 2, True),
         (4, 64, 20, 1, True), (4, 64, 20, 2, True), (3, 64, 7, 8, True)]


@pytest.mark.parametrize("B,S,V,A,opt", CASES)
def test_plain_tiled_matches_jax_pallas_and_f64(B, S, V, A, opt):
    """pair_llks on CPU tensors (the plain K5' + K4' and the reassembly)
    against JAX pair_llks_pallas(interpret=True), which takes the tiled
    kernels too: within 1e-5 relative; against the JAX f64 path within the
    fast-mode 2e-5 (relative, scale max(1, |x|)). opt turns on a0_sep and
    sym_a; the mirrored alpha == 0.5 plane equals its transpose bit for
    bit."""
    import jax.numpy as jnp

    from demuxlet_tpu.models.likelihood import pair_llks
    from demuxlet_tpu.ops.pallas_pair import pair_llks_pallas

    assert V * V * A > TP.UNROLL_CAP
    (cnt, msk, gps, gp0, w), (cnt_t, gps_t, wt), t = _packed(B, S, V, A)
    sym_a = A - 1 if opt and A > 1 else None
    ref_ab, ref_00 = pair_llks(
        jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
        jnp.asarray(gp0), jnp.asarray(w), A,
    )
    jab, j00 = pair_llks_pallas(
        jnp.asarray(cnt_t), jnp.asarray(gps_t), jnp.asarray(wt), A, V,
        interpret=True, a0_sep=opt, sym_a=sym_a,
    )
    ab, z0 = TP.pair_llks(t, torch.from_numpy(gps_t), V, A, a0_sep=opt,
                          sym_a=sym_a)
    assert ab.dtype == z0.dtype == torch.float32
    assert ab.shape == tuple(jab.shape) and z0.shape == tuple(j00.shape)
    assert _rel(ab, jab) < 1e-5
    assert _rel(z0, j00) < 1e-5
    assert _rel(ab.numpy()[:B], ref_ab) < TOL
    assert _rel(z0.numpy()[:B], ref_00) < TOL
    if sym_a is not None:
        plane = ab[..., sym_a]
        assert torch.equal(plane, plane.transpose(1, 2))


def test_plain_extras_matches_jax_extras_many_alphas():
    """extras_fast_plain against JAX _call_extras_only (interpret mode) on
    a pool of many alphas and no separable plane (V=2, A=97, V*V*A = 388:
    97 m0 columns and no sample column), with host background rows given
    apart: within 1e-5 relative (scale max(1, |x|)); the JAX kernel's
    columns past n_x are its lane padding."""
    import jax.numpy as jnp

    from demuxlet_tpu.ops.pallas_pair import _call_extras_only

    V, A = 2, 97
    assert V * V * A > TP.UNROLL_CAP
    _, (_, gps_t, _), t = _packed(4, 64, V, A)
    rng = np.random.default_rng(A)
    gp0 = rng.dirichlet(np.ones(3), size=t.shape[1:]).astype(np.float32)
    gp0_t = torch.from_numpy(np.ascontiguousarray(gp0.transpose(2, 0, 1)))
    expand = tuple(range(A * 9))
    got = PT.extras_fast_plain(t, torch.from_numpy(gps_t), gp0_t, V, A,
                               False, expand)
    n_x = len(PT.extras_keys(V, A, False, singlets=False))
    assert got.dtype == torch.float32 and got.shape == (t.shape[1], n_x)
    want = _call_extras_only(jnp.asarray(t.numpy()), jnp.asarray(gps_t),
                             jnp.asarray(gp0_t.numpy()), V, A, True, False,
                             expand)
    assert _rel(got, np.asarray(want)[:, :n_x]) < 1e-5


@pytest.mark.parametrize("V,A", [(8, 5), (16, 2), (17, 3)])
def test_background_rows_per_route(V, A):
    """llk_00 takes its background rows as the JAX package's route of the
    same V, A does: the unrolled K1 route (V=8, A=5) its in-kernel f32
    sample mean, whatever gp0_t says (bit for bit); the tiled route the
    given gp0_t (the front's host gp0), against JAX _call_pair_kernel(...,
    gp0_t=...) in interpret mode within 1e-5 relative."""
    import jax.numpy as jnp

    from demuxlet_tpu.ops.pallas_pair import _call_pair_kernel

    _, (_, gps_t, _), t = _packed(4, 64, V, A)
    rng = np.random.default_rng(V * A)
    gp0 = rng.dirichlet(np.ones(3), size=t.shape[1:]).astype(np.float32)
    gp0_t = torch.from_numpy(np.ascontiguousarray(gp0.transpose(2, 0, 1)))
    g = torch.from_numpy(gps_t)
    cols, expand = TP.dedup_channels(_grid(A))
    tx = t[list(cols)].contiguous()  # the deduplicated table
    kw = dict(a0_sep=True, sym_a=A - 1, expand=expand)
    ab, z0 = TP.pair_llks(tx, g, V, A, gp0_t=gp0_t, **kw)
    ab_mean, z0_mean = TP.pair_llks(tx, g, V, A, **kw)
    assert torch.equal(ab, ab_mean)
    if V * V * A <= TP.UNROLL_CAP:
        assert torch.equal(z0, z0_mean)  # K1 ignores gp0_t
        return
    assert _rel(z0, z0_mean) > 1e-3  # the given rows are used
    jab, j00 = _call_pair_kernel(jnp.asarray(tx.numpy()), jnp.asarray(gps_t),
                                 V, A, True, gp0_t=jnp.asarray(gp0_t.numpy()),
                                 **kw)
    assert _rel(ab, jab) < 1e-5 and _rel(z0, j00) < 1e-5


@pytest.mark.parametrize("a0_sep,sym", [(True, True), (False, False)])
def test_all_padding_block_is_exactly_zero(a0_sep, sym):
    """No observation anywhere on a V=20 pool through the fast front (the
    tiled route): every LLK is exactly 0."""
    codes = np.full((8, 128, 2), 255, dtype=np.uint8)
    idx = np.zeros((8, 128), np.int32)
    msk = np.zeros((8, 128), bool)
    gps = np.random.default_rng(0).dirichlet(np.ones(3), size=(10, 20))
    grid = _grid(3)
    tab = TE.place(TE.host_tables(gps, grid, 40, None), CPU)
    out = fast_front(_parts(codes, idx, msk), tab, 3, 20, a0_sep=a0_sep,
                     sym_a=2 if sym else None)
    assert out[2].shape == (8, 20, 20, 3)
    for x in out:
        assert bool((x == 0).all())


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("V,A", [(16, 2), (17, 3)])
def test_run_compact_matches_jax_run(V, A):
    """Port fast run_compact on a large pool against the JAX engine's fast
    run() (the tiled Pallas kernels in interpret mode) +
    compact_from_result: floats within 2e-5 relative, integer fields equal
    (best_flat modulo the alpha == 0.5 swap: on a multi-alpha grid the JAX
    package computes (j, k) and (k, j) apart, the port mirrors)."""
    from demuxlet_tpu.models import decision as JD
    from demuxlet_tpu.models import engine as JE
    from test_torch_engine import _pcr_hot_csr

    grid = _grid(A)
    csr, gps = _pcr_hot_csr(V, n_cells=24, NS=120, V=V, per_cell=(10, 30))
    port = TE.DemuxEngine(gps, grid, cell_block=8, mode="fast", device=CPU)
    l_t, l0_t, c_t = port.run_compact(csr, doublet_prior=0.5)
    csr_j, _ = _pcr_hot_csr(V, n_cells=24, NS=120, V=V, per_cell=(10, 30))
    res = JE.DemuxEngine(gps, grid, cell_block=8, mode="fast").run(csr_j)
    c_j = JD.compact_from_result(res.llk_ab, res.llk_00, grid, 0.5)
    assert _rel(l_t, res.llks) < TOL and _rel(l0_t, res.llk0s) < TOL
    for name in ("sing_col", "llk_00", "max_llk", "max_sing2", "pair_llk12",
                 "sum_single", "sum_double"):
        got, want = getattr(c_t, name), getattr(c_j, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert _rel(got, want) < TOL, name
    for name in ("i_sing1", "i_sing2"):
        np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name))
    assert _swap_equal(c_t.best_flat, c_j.best_flat, V, A,
                       grid.index(0.5)).all()


def test_fast_matches_exact_at_v16():
    """Port fast run_compact against the port's exact mode on a V=16 pool
    (V*V*A = 512: K5' + K4' against K7' + K6', their plain versions here)
    within 2e-4 relative, as tests/test_pallas.py holds the JAX modes; the
    singlet calls are equal."""
    from test_torch_engine import _pcr_hot_csr

    grid = [0.0, 0.5]
    csr, gps = _pcr_hot_csr(5, n_cells=24, NS=120, V=16, per_cell=(10, 30))
    fast = TE.DemuxEngine(gps, grid, cell_block=8, mode="fast", device=CPU)
    exact = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    lf, l0f, cf = fast.run_compact(csr, 0.5)
    lx, l0x, cx = exact.run_compact(csr, 0.5)
    assert _rel(lf, lx) < 2e-4 and _rel(l0f, l0x) < 2e-4
    for name in ("sing_col", "llk_00", "max_llk", "sum_single", "sum_double"):
        assert _rel(getattr(cf, name), getattr(cx, name)) < 2e-4, name
    np.testing.assert_array_equal(cf.i_sing1, cx.i_sing1)


def test_plain_fast_tiled_keeps_f32_and_matches_unrolled_math():
    """pair_tiled_plain and extras_fast_plain stay in f32 on f32 inputs,
    and the tiled reassembly equals the unrolled plain K1 math with the
    same background rows within 1e-6 relative (V=12, A=3: the unrolled
    plain version runs at any size)."""
    rng = np.random.default_rng(12)
    V, A, B, S = 12, 3, 4, 64
    t = torch.from_numpy(rng.random((A * 9, B, S)).astype(np.float32) + 0.05)
    g = torch.from_numpy(np.ascontiguousarray(rng.dirichlet(
        np.ones(3), size=(V + 1, B, S)).transpose(0, 3, 1, 2).reshape(
            3 * V + 3, B, S)).astype(np.float32))
    gps_t, gp0_t = g[: 3 * V], g[3 * V :]
    for a0_sep, sym_a in ((True, 2), (False, 2), (False, None)):
        plan = PT.plan_tiles(V, A, a0_sep, sym_a)
        got = PT.pair_fast_tiled(t, gps_t, gp0_t, V, A, a0_sep, sym_a)
        assert all(x.dtype == torch.float32 for x in got)
        assert PT.pair_tiled_plain(t, gps_t, V, A, plan,
                                   tuple(range(A * 9))).dtype == torch.float32
        want = TP._pair_plain_chunk(t.reshape(A, 3, 3, B, S),
                                    gps_t.reshape(V, 3, B, S), V, A, a0_sep,
                                    sym_a, g0=gp0_t)
        for x, y in zip(got, want):
            assert x.shape == y.shape and _rel(x, y) < 1e-6


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K5' and K4' have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid", [
    (16, 256, 32, _grid(5)),
    (16, 256, 32, [0.0, 0.5]),
    # the benchmark's widest pool (kang64_a2_fast): 10 tile items a cell
    (16, 256, 64, [0.0, 0.5]),
    (40, 384, 7, _grid(8)),  # ragged edge, 8-tiles
    (40, 384, 17, _grid(3)),  # ragged edge, 16-tiles
    (33, 200, 20, [0.0, 0.5]),
    (16, 130, 20, [0.5, 0.1]),  # no separable plane; S not a warp multiple
    (16, 128, 24, [0.0]),  # single-point alpha == 0 grid: K4' alone
])
def test_k5_k4_match_plain_and_likelihood_on_card(cuda_device, B, S, V,
                                                  grid):
    """The fast block step through K5' and K4' on the card (fast_front on a
    large pool) against the same step with the plain pair search on the
    card within 2e-5 relative, and against the port's dense likelihood
    kernels (ops/likelihood.py) in f64 within 2e-5 and in f32 within 1e-4
    (relative, scale max(1, |x|)); K1 is never launched, two launches give
    identical bits (no atomics), and the alpha == 0.5 plane equals its
    transpose."""
    from demuxlet_tpu_torch.kernels import extras_fast as k4
    from demuxlet_tpu_torch.kernels import pair_fast as k1
    from demuxlet_tpu_torch.kernels import pair_tiled_fast as k5

    A = len(grid)
    assert V * V * A > TP.UNROLL_CAP
    codes, idx, msk, gps, _ = _workload(V + S, B=B, S=S, U=3, V=V)
    tab = TE.place(TE.host_tables(gps, grid, 40, None), cuda_device)
    a0_sep = grid[0] == 0.0
    sym_a = grid.index(0.5) if 0.5 in grid else None
    args = (_parts(codes, idx, msk, cuda_device), tab, A, V)
    kw = dict(a0_sep=a0_sep, sym_a=sym_a)
    plan = PT.plan_tiles(V, A, a0_sep, sym_a)
    before = (k5.launches, k4.launches, k1.launches)
    got = fast_front(*args, **kw)
    again = fast_front(*args, **kw)
    torch.cuda.synchronize()
    n5 = 2 if plan.items else 0
    assert (k5.launches, k4.launches, k1.launches) == (
        before[0] + n5, before[1] + 2, before[2])
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    plain = fast_front(*args, pair_fn=TP.pair_llks_plain, **kw)
    for x, y in zip(got, plain):
        assert _rel(x.cpu(), y.cpu()) < TOL
    if sym_a is not None:
        plane = got[2][..., sym_a]
        assert torch.equal(plane, plane.transpose(1, 2))
    ref64 = _likelihood_f64(codes, idx, msk, gps, grid, device=cuda_device)
    for x, ref in zip(got, ref64):
        assert x.shape == ref.shape and _rel(x.cpu(), ref) < TOL
    from demuxlet_tpu_torch.ops import likelihood as TL
    from demuxlet_tpu_torch.ops import luts
    from test_torch_exact import _dense, _gathered

    cnt = _dense(codes, msk, 2 * 41)
    t32 = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_device)
           for x in (cnt, msk, *_gathered(idx, msk, gps),
                     luts.pair_lut(grid, 40))]
    ab32, z032 = TL.pair_llks(*t32, A, dtype=torch.float32)
    assert _rel(got[2].cpu(), ab32.cpu()) < 1e-4
    assert _rel(got[3].cpu(), z032.cpu()) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid,edge", [
    (6, 384, 7, _grid(8), None),  # ragged edge, 8-tiles
    (6, 384, 17, _grid(3), None),  # ragged edge, 16-tiles
    (2, 8192, 32, [0.0, 0.5], None),  # deep: the exponents run far
    # S neither a multiple of the 128-slot chunk nor of 4 (4-byte copies)
    (8, 1001, 17, _grid(3), "floor"),
    (4, 200, 7, _grid(8), "floor"),
    (4, 256, 32, _grid(5), "special"),
    (4, 130, 20, [0.5, 0.1], "special"),
    (4, 200, 20, [0.0, 0.5], "padding"),
])
def test_k5_matches_plain_on_card(cuda_device, B, S, V, grid, edge):
    """K5' alone against pair_tiled_plain on the card, on inputs with the
    edge cases of ``edge_inputs`` in f32: within 2e-5 relative (scale
    max(1, |x|); equal infinities and NaNs match), two launches give
    identical bits, the alpha == 0.5 plane equals its transpose;
    exact-zero and NaN inner values give -inf and NaN, an all-padding
    block exact zeros."""
    from demuxlet_tpu_torch.kernels import pair_tiled_fast as k5
    from test_torch_exact import assert_close_on_card
    from test_torch_pair import card_inputs

    A = len(grid)
    t, g, expand, a0_sep, sym_a = card_inputs(B, S, V, grid, cuda_device,
                                              edge)
    plan = PT.plan_tiles(V, A, a0_sep, sym_a)
    before = k5.launches
    got = PT.pair_tiled_fast(t, g, V, A, plan, expand)
    again = PT.pair_tiled_fast(t, g, V, A, plan, expand)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    assert_close_on_card(got, PT.pair_tiled_plain(t, g, V, A, plan, expand),
                         TOL, relative=True)
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    if edge == "padding":
        assert bool((got == 0).all())
    if sym_a is not None:
        plane = got[..., sym_a].nan_to_num()
        assert torch.equal(plane, plane.transpose(1, 2))
    if edge == "special":
        assert bool(torch.isneginf(got[0, 1, 1, list(plan.alist)]).all())
        assert bool(torch.isnan(got[1, :, :, A - 1]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid,edge", [
    (16, 512, 32, [0.0, 0.5], None),
    (8, 333, 32, _grid(5), None),  # S odd: 4-byte copies only
    (2, 8192, 32, [0.0, 0.5], None),  # deep: the exponents run far
    (16, 130, 20, [0.5, 0.1], None),  # no separable plane: no sample rows
    (16, 128, 24, [0.0], None),  # single-point alpha == 0 grid
    (4, 256, 1, _grid(400), None),  # rounds of alphas
    (4, 200, 70, [0.0, 0.5], None),  # two rounds of samples
    # S neither a multiple of the 128-slot chunk nor of 4 (4-byte copies)
    (8, 1001, 17, _grid(3), "floor"),
    (4, 256, 32, _grid(5), "special"),
    (4, 130, 20, [0.5, 0.1], "special"),
    (4, 200, 20, [0.0, 0.5], "padding"),
])
def test_k4_matches_plain_on_card(cuda_device, B, S, V, grid, edge):
    """K4' alone against extras_fast_plain on the card, on inputs with the
    edge cases of ``edge_inputs`` in f32 and background rows that are the
    samples' mean: within 2e-5 relative (scale max(1, |x|); equal
    infinities and NaNs match), two launches give identical bits and each
    counts one launch; exact-zero and NaN inner values give -inf and NaN,
    an all-padding block exact zeros; across its rounds of samples and of
    alphas and slot counts that the 16-byte copies do not divide."""
    from demuxlet_tpu_torch.kernels import extras_fast as k4
    from test_torch_exact import assert_close_on_card
    from test_torch_pair import card_inputs

    A = len(grid)
    t, g, expand, a0_sep, _ = card_inputs(B, S, V, grid, cuda_device, edge)
    g0 = g.view(V, 3, B, S).mean(dim=0).contiguous()
    args = (t, g, g0, V, A, a0_sep, expand)
    before = k4.launches
    got = PT.extras_fast(*args)
    assert k4.launches == before + 1
    again = PT.extras_fast(*args)
    torch.cuda.synchronize()
    assert k4.launches == before + 2
    assert got.shape == (B, len(PT.extras_keys(V, A, a0_sep,
                                               singlets=False)))
    assert torch.equal(got.nan_to_num(), again.nan_to_num())
    assert torch.equal(got.isnan(), again.isnan())
    assert_close_on_card(got, PT.extras_fast_plain(*args), TOL,
                         relative=True)
    if edge == "padding":
        assert bool((got == 0).all())
    if edge == "special":
        if a0_sep:  # sample 1's zero row: its d and gs columns
            assert bool(torch.isneginf(got[0, [1, V + 1]]).all())
        assert bool(torch.isnan(got[1, -1]))  # the last alpha's NaN t value
