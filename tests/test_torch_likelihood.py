"""Port of models/likelihood.py (demuxlet_tpu_torch/ops/likelihood.py)
against the JAX f64/f32 kernels and the NumPy oracle on the same inputs."""

import random

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu.host.slots import build_slots
from demuxlet_tpu.models import likelihood as JL
from demuxlet_tpu.ops import luts
from demuxlet_tpu_torch.ops import likelihood as TL

torch.set_num_threads(2)


def _case(seed, B, S, V, A, nb=82):
    """Counts, mask and posteriors as tests/test_pallas_exact.py makes
    them, extreme posteriors included; padded slots carry neutral rows."""
    rng = np.random.default_rng(seed)
    cnt = rng.integers(0, 3, size=(B, S, nb)) * (rng.random((B, S, nb)) < 0.04)
    msk = rng.random((B, S)) < 0.85
    cnt = (cnt * msk[:, :, None]).astype(np.int32)
    gps = rng.dirichlet(np.ones(3), size=(B, S, V))
    tiny = rng.random((B, S, V)) < 0.1
    gps[tiny] = np.array([1 - 2e-8, 1e-8, 1e-8])
    gp0 = gps.mean(axis=2)
    neutral = np.array([1.0, 0.0, 0.0])
    gps = np.where(msk[:, :, None, None], gps, neutral)
    gp0 = np.where(msk[:, :, None], gp0, neutral)
    grid = np.linspace(0, 0.5, A).tolist()
    return cnt, msk, gps, gp0, luts.pair_lut(grid, 40), luts.singlet_lut(40)


def _both(cnt, msk, gps, gp0, w, logf, A, slot_chunk, jdt, tdt):
    j = (JL.singlet_llks(jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
                         jnp.asarray(gp0), jnp.asarray(logf), dtype=jdt)
         + JL.pair_llks(jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
                        jnp.asarray(gp0), jnp.asarray(w), A,
                        slot_chunk=slot_chunk, dtype=jdt))
    tt = [torch.from_numpy(x) for x in (cnt, msk, gps, gp0)]
    t = (TL.singlet_llks(*tt, torch.from_numpy(logf), dtype=tdt)
         + TL.pair_llks(*tt, torch.from_numpy(w), A, slot_chunk=slot_chunk,
                        dtype=tdt))
    return [np.asarray(x, np.float64) for x in j], \
        [x.double().numpy() for x in t]


@pytest.mark.parametrize("B,S,V,A,slot_chunk", [
    (4, 64, 3, 2, 0),
    (3, 100, 4, 5, 0),
    (4, 96, 2, 3, 32),  # chunked slot axis
    (2, 128, 3, 2, 64),
])
def test_matches_jax_f64(B, S, V, A, slot_chunk):
    """f64: within 1e-10 absolute of JAX (only the summation order of the
    count contraction and of the slot sums may differ)."""
    cnt, msk, gps, gp0, w, logf = _case(B + S + V, B, S, V, A)
    want, got = _both(cnt, msk, gps, gp0, w, logf, A, slot_chunk,
                      jnp.float64, torch.float64)
    for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        assert g.shape == ref.shape, name
        assert np.abs(g - ref).max() < 1e-10, name


def test_matches_jax_f32():
    """f32: within 2e-5 relative (scale max(1, |x|)) of JAX f32, the
    fast-mode contract; f32 sums in another order differ in the last bits."""
    cnt, msk, gps, gp0, w, logf = _case(3, 4, 64, 3, 3)
    want, got = _both(cnt, msk, gps, gp0, w, logf, 3, 0, jnp.float32,
                      torch.float32)
    for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        err = np.abs(g - ref) / np.maximum(1.0, np.abs(ref))
        assert err.max() < 2e-5, name


@pytest.mark.parametrize("seed,grid", [(1, [0.0, 0.5]),
                                       (3, [0.0, 0.1, 0.2, 0.3, 0.5])])
def test_matches_oracle(seed, grid):
    """On a dict pileup with real UMI observations: within 1e-9 absolute
    of the oracle's pass1_singlet and pass2_cell (tests/test_engine.py's
    contract)."""
    from oracle.numpy_oracle import (
        PileupData,
        compute_gp0s,
        pass1_singlet,
        pass2_cell,
    )

    rng = random.Random(seed)
    nv, nsnps = 3, 40
    g = np.random.RandomState(seed).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = PileupData([f"S{i}" for i in range(nv)], [g[i] for i in range(nsnps)])
    for c in range(8):
        scl.add_cell(f"BC{c:03d}")
        for _ in range(60):
            scl.cell_totl[c] += 1
            scl.add_read(rng.randrange(nsnps), c, f"U{rng.randrange(10000)}",
                         rng.choice([0, 0, 1, 1, 2]), rng.randrange(13, 41))
    gp0s = compute_gp0s(scl)
    blk = build_slots(scl, list(range(scl.nbcs)), cap_bq=40)
    gps_all = np.stack(scl.snp_gps)
    neutral = np.array([1.0, 0.0, 0.0])
    gps_g = np.where(blk.msk[..., None, None], gps_all[blk.idx], neutral)
    gp0_g = np.where(blk.msk[..., None], gp0s[blk.idx], neutral)
    tt = [torch.from_numpy(x) for x in (blk.cnt, blk.msk, gps_g, gp0_g)]
    llk, llk0 = TL.singlet_llks(*tt, torch.from_numpy(luts.singlet_lut(40)))
    ab, z0 = TL.pair_llks(*tt, torch.from_numpy(luts.pair_lut(grid, 40)),
                          len(grid))
    o_llks, o_llk0s = pass1_singlet(scl, gp0s)
    assert np.abs(llk.numpy() - o_llks).max() < 1e-9
    assert np.abs(llk0.numpy() - o_llk0s).max() < 1e-9
    for c in range(scl.nbcs):
        o_ab, _, o_00 = pass2_cell(scl, gp0s, c, grid)
        assert np.abs(ab[c].numpy() - o_ab).max() < 1e-9
        assert np.abs(z0[c].numpy() - o_00).max() < 1e-9


def test_slot_chunk_not_dividing_s_stays_finite():
    """A slot chunk that does not divide S (384 of 512 slots, the dense
    route's --slot-chunk 384): the JAX pair_llks_impl zero-pads the last
    chunk, whose padded slots give log(0) * 0 = NaN in every LLK (a fault
    of the reference); the port sums a shorter last chunk and gives finite
    LLKs within 1e-12 of its own and of JAX's at slot_chunk=512."""
    cnt, msk, gps, gp0, w, logf = _case(9, 2, 512, 3, 3)
    tt = [torch.from_numpy(x) for x in (cnt, msk, gps, gp0)]
    tw = torch.from_numpy(w)
    jargs = [jnp.asarray(x) for x in (cnt, msk, gps, gp0, w)]
    j384 = [np.asarray(x) for x in JL.pair_llks(*jargs, 3, slot_chunk=384)]
    assert all(np.isnan(x).all() for x in j384)
    j512 = [np.asarray(x) for x in JL.pair_llks(*jargs, 3, slot_chunk=512)]
    t384 = [x.numpy() for x in TL.pair_llks(*tt, tw, 3, slot_chunk=384)]
    t512 = [x.numpy() for x in TL.pair_llks(*tt, tw, 3, slot_chunk=512)]
    for got, own, ref in zip(t384, t512, j512):
        assert np.isfinite(got).all()
        assert np.abs(got - own).max() <= 1e-12
        assert np.abs(got - ref).max() <= 1e-12
