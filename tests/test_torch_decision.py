"""Port decision pass (demuxlet_tpu_torch/models/decision.py) against the
JAX module: decide and the packed compact rows on identical f64 inputs,
and the copied JAX-free helpers."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu.models import decision as JD
from demuxlet_tpu_torch.models import decision as TD

torch.set_num_threads(2)

INT_KEYS = ("i_sing1", "i_sing2", "best_flat")


def _llks(rng, B, V, A):
    """f32-valued LLKs (what the kernels emit) with planted exact ties:
    a repeated singlet maximum and a repeated doublet maximum."""
    ab = rng.normal(-300.0, 40.0, size=(B, V, V, A)).astype(np.float32)
    z0 = rng.normal(-300.0, 40.0, size=(B, A)).astype(np.float32)
    if V > 2:
        ab[0, 2, 0, 0] = ab[0, 1, 0, 0] = ab[0].max() + 5  # singlet tie
    if V > 2 and A > 1:
        ab[1, 0, 2, A - 1] = ab[1, 2, 1, A - 1] = ab[1].max() + 5
    return ab, z0


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("V,grid,prior", [
    (4, [0.0, 0.5], 0.5),
    (5, [0.0, 0.1, 0.25, 0.5], 0.3),
    (3, [0.1, 0.3], 0.5),
    (1, [0.0, 0.5], 0.5),  # no doublets: all-masked argmax
    (4, [0.0], 0.2),
])
def test_decide_matches_jax(V, grid, prior):
    rng = np.random.default_rng(V * 10 + len(grid))
    A = len(grid)
    ab, z0 = _llks(rng, 12, V, A)
    w = TD.doublet_weights(V, grid, prior)
    m = TD.doublet_mask(V, A)
    want = JD.decide(jnp.asarray(ab, jnp.float64), jnp.asarray(z0, jnp.float64),
                     jnp.asarray(w), jnp.asarray(m), prior)
    got = TD.decide(torch.from_numpy(ab).double(), torch.from_numpy(z0).double(),
                    torch.from_numpy(w), torch.from_numpy(m), prior)
    assert set(got) == set(want)
    for k in got:
        g, j = got[k].numpy(), np.asarray(want[k])
        if k in INT_KEYS:
            np.testing.assert_array_equal(g, j, err_msg=k)
        else:
            assert _rel(g, j) < 1e-12, k


def test_compact_rows_match_jax(monkeypatch):
    """compact_step_body of both packages on the same block-step outputs
    (the fronts replaced by one fixed result): integer fields equal, float
    fields within 1e-12 relative, in the same (B, 2V+A+11) layout."""
    import demuxlet_tpu.ops.pallas_pair as PP

    rng = np.random.default_rng(4)
    V, grid, prior = 4, [0.0, 0.25, 0.5], 0.5
    A = len(grid)
    ab, z0 = _llks(rng, 16, V, A)
    llk = rng.normal(-200, 30, size=(16, V)).astype(np.float32)
    llk0 = rng.normal(-250, 30, size=16).astype(np.float32)
    monkeypatch.setattr(PP, "demux_block_fast_impl", lambda *a, **k: (
        jnp.asarray(llk), jnp.asarray(llk0), jnp.asarray(ab),
        jnp.asarray(z0)))
    monkeypatch.setattr(TD, "front_half", lambda *a, **k: ())
    monkeypatch.setattr(TD, "pair_half", lambda *a, **k: (
        torch.from_numpy(llk), torch.from_numpy(llk0), torch.from_numpy(ab),
        torch.from_numpy(z0)))
    w = TD.doublet_weights(V, grid, prior)
    m = TD.doublet_mask(V, A)
    want = np.asarray(JD.compact_step_body(
        None, None, None, None, None, None, None, jnp.asarray(w),
        jnp.asarray(m), A, V, prior))
    got = TD.compact_step_body(
        None, None, A, V, torch.from_numpy(w), torch.from_numpy(m),
        prior).numpy()
    assert got.shape == want.shape == (16, 2 * V + A + 11)
    assert got.dtype == want.dtype == np.float64
    gl, g0, gc = TD.unpack_block(got, V, A)
    jl, j0, jc = JD.unpack_block(want, V, A)
    np.testing.assert_array_equal(gl, jl)
    np.testing.assert_array_equal(g0, j0)
    for k in gc:
        if k in INT_KEYS:
            np.testing.assert_array_equal(gc[k], jc[k], err_msg=k)
        else:
            assert _rel(gc[k], jc[k]) < 1e-12, k


def test_copied_helpers_equal_jax():
    for V, grid, prior in ((4, [0.0, 0.5], 0.5), (3, [0.0, 0.2, 0.5], 0.1),
                           (1, [0.0, 0.5], 0.5), (5, [0.3], 0.5)):
        np.testing.assert_array_equal(TD.doublet_weights(V, grid, prior),
                                      JD.doublet_weights(V, grid, prior))
        np.testing.assert_array_equal(TD.doublet_mask(V, len(grid)),
                                      JD.doublet_mask(V, len(grid)))
    assert TD._PACK_KEYS == JD._PACK_KEYS
    assert ([f.name for f in dataclasses.fields(TD.CompactResult)]
            == [f.name for f in dataclasses.fields(JD.CompactResult)])
    rng = np.random.default_rng(0)
    V, A = 3, 2
    packed = [rng.normal(size=(n, 2 * V + A + 11)) for n in (5, 7)]
    for p in packed:
        p[:, V + A + 3 : V + A + 5] = rng.integers(0, V, size=(len(p), 2))
        p[:, V + A + 6] = rng.integers(0, V * V * A, size=len(p))
    tparts = [TD.unpack_block(p, V, A) for p in packed]
    jparts = [JD.unpack_block(p, V, A) for p in packed]
    for (tl, t0, tc), (jl, j0, jc) in zip(tparts, jparts):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(t0, j0)
        assert tc.keys() == jc.keys()
    tcat = TD.concat([c for _, _, c in tparts])
    jcat = JD.concat([c for _, _, c in jparts])
    perm = rng.permutation(12)
    for a, b in ((tcat, jcat), (TD.take(tcat, perm), JD.take(jcat, perm))):
        for f in dataclasses.fields(JD.CompactResult):
            x, y = getattr(a, f.name), getattr(b, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
    # compact_from_result (numpy) on full LLK tensors, with exact ties on
    # the mirrored alpha == 0.5 plane and V = 1 (no doublet channel)
    for V, grid in ((4, [0.0, 0.25, 0.5]), (1, [0.0, 0.5])):
        A = len(grid)
        ab = rng.normal(-50, 10, size=(9, V, V, A))
        ab[..., A - 1] = ab[..., A - 1] + ab[..., A - 1].transpose(0, 2, 1)
        z0 = rng.normal(-50, 10, size=(9, A))
        got = TD.compact_from_result(ab, z0, grid, 0.3)
        want = JD.compact_from_result(ab, z0, grid, 0.3)
        for f in dataclasses.fields(JD.CompactResult):
            x, y = getattr(got, f.name), getattr(want, f.name)
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
