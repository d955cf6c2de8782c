"""Exact mode of the port against the JAX package and the oracle:
the exact tables, the f64 front (K2' plain version, on full lanes and on
the wire-v2 parts), the f64 pair search (K3' plain version), exact
run_compact and the CLI's default mode; and, on a card, K2' and K3'
against their plain versions.

JAX is imported inside the tests that compare with it, so the ``cuda``
tests also collect where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_exact.py``."""

import random

import numpy as np
import pytest
import torch

from demuxlet_tpu.ops import luts
from demuxlet_tpu_torch.host import wire as TWH
from demuxlet_tpu_torch.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops import front_exact as TF
from demuxlet_tpu_torch.ops import likelihood as TL
from demuxlet_tpu_torch.ops import pair_exact as TP
from demuxlet_tpu_torch.ops import wire as TW

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID5 = np.linspace(0.0, 0.5, 5).tolist()


def _workload(seed, B=16, S=128, U=3, V=3, A=3, NS=100, cap=40):
    """tests/test_pallas_exact.py's block: explicit codes (255 = none),
    ~10% masked slots, extreme posteriors."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 2 * (cap + 1), size=(B, S, U)).astype(np.uint8)
    codes[rng.random((B, S, U)) < 0.35] = 255
    idx = rng.integers(0, NS, size=(B, S)).astype(np.int32)
    msk = rng.random((B, S)) < 0.9
    codes[~msk] = 255
    gps = rng.dirichlet(np.ones(3), size=(NS, V))
    gps[rng.random((NS, V)) < 0.1] = np.array([1 - 2e-8, 1e-8, 1e-8])
    return codes, idx, msk, gps, np.linspace(0.0, 0.5, A).tolist()


def _dense(codes, msk, nb):
    """Per-slot counts of the codes below nb (255 and the other codes at
    or past nb are none)."""
    B, S, U = codes.shape
    cnt = np.zeros((B, S, nb), dtype=np.int32)
    for u in range(U):
        c = codes[..., u].astype(np.int64)
        valid = (c < nb) & msk
        bi, si = np.nonzero(valid)
        np.add.at(cnt, (bi, si, c[valid]), 1)
    return cnt


def _gathered(idx, msk, gps):
    """Per-slot gps and gp0 rows, neutral on masked slots."""
    neutral = np.array([1.0, 0.0, 0.0])
    return (np.where(msk[..., None, None], gps[idx], neutral),
            np.where(msk[..., None], TE.compute_gp0(gps)[idx], neutral))


def _parts(codes, idx, msk, device=CPU):
    """A decoded block of full-lane codes with an explicit mask."""
    return TW.Parts(torch.from_numpy(codes.astype(np.int32)).to(device),
                    None, 0, torch.from_numpy(idx).long().to(device),
                    torch.from_numpy(msk).to(device))


def _port_block(codes, idx, msk, gps, grid, cap=40, **kw):
    tab = TE.place(TE.exact_host_tables(gps, grid, cap, None), CPU)
    return TF.exact_block(_parts(codes, idx, msk), tab, len(grid),
                          gps.shape[1], **kw)


def _jax_f64(codes, idx, msk, gps, grid, cap=40, rows=None):
    """JAX f64 likelihood kernels on the equivalent dense block; under a
    wire-v2 dictionary ``rows`` the codes index its LUT rows."""
    import jax.numpy as jnp

    from demuxlet_tpu.models.likelihood import pair_llks, singlet_llks

    w, logf = luts.pair_lut(grid, cap), luts.singlet_lut(cap)
    if rows is not None:
        w, logf = w[list(rows)], logf[list(rows)]
    cnt = jnp.asarray(_dense(codes, msk, w.shape[0]), jnp.float64)
    args = (cnt, jnp.asarray(msk), *map(jnp.asarray, _gathered(idx, msk, gps)))
    llk, llk0 = singlet_llks(*args, jnp.asarray(logf), dtype=jnp.float64)
    ab, z0 = pair_llks(*args, jnp.asarray(w), len(grid), slot_chunk=0,
                       dtype=jnp.float64)
    return [np.asarray(x) for x in (llk, llk0, ab, z0)]


def _likelihood_f64(codes, idx, msk, gps, grid, cap=40, rows=None,
                    device=CPU):
    """The port's dense f64 likelihood kernels (ops/likelihood.py) on the
    equivalent dense block, on the given device; under a wire-v2
    dictionary ``rows`` the codes index its LUT rows."""
    w, logf = luts.pair_lut(grid, cap), luts.singlet_lut(cap)
    if rows is not None:
        w, logf = w[rows], logf[rows]
    cnt = _dense(codes, msk, w.shape[0])
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(device)
         for x in (cnt, msk, *_gathered(idx, msk, gps), w, logf)]
    llk, llk0 = TL.singlet_llks(*t[:4], t[5])
    ab, z0 = TL.pair_llks(*t[:5], len(grid))
    return [x.cpu().numpy() for x in (llk, llk0, ab, z0)]


# ---------------------------------------------------------------- tables

@pytest.mark.parametrize("grid,cap,narrow", [
    ([0.0, 0.5], 40, False),
    (GRID5, 40, True),
    ([0.1, 0.3], 63, False),
    ([0.0, 0.25, 0.5], 126, True),
])
def test_exact_tables_match_split_tables(grid, cap, narrow):
    """exp of the log LUT equals split_tables' probabilities (to 1 ulp of
    f64 against np.exp, and to df32 precision against its single-code
    planes); expand, gsel and cmask equal its meta and the JAX mixture
    mask; the g table holds f64 gps, gp0 and the neutral column."""
    from demuxlet_tpu.host.wire import WireCfg
    from demuxlet_tpu.ops import pallas_pair_exact as PE

    rng = np.random.default_rng(cap)
    gps = rng.dirichlet(np.ones(3), size=(30, 4))
    gp0 = TE.compute_gp0(gps)
    w, logf = luts.pair_lut(grid, cap), luts.singlet_lut(cap)
    rows = sorted(rng.choice(2 * (cap + 1), size=9, replace=False).tolist())
    cfg = WireCfg(tuple(rows), 4, 8) if narrow else None
    tab = TE.place(TE.exact_host_tables(gps, grid, cap, cfg), CPU)
    _, _, tabs, meta = PE.split_tables(gps, gp0, w, logf,
                                       rows=rows if narrow else None)
    C, expand_w, expand_gl = meta
    assert tab.lut.shape == (len(rows) + 1 if narrow else w.shape[0] + 1, C)
    assert tab.expand == expand_w and tab.gsel == expand_gl
    used = sorted(set(expand_w))
    want_cmask = (None if used == list(range(C))
                  else tuple(i in used for i in range(C)))
    assert (tab.cmask if not all(tab.cmask) else None) == want_cmask
    lut = tab.lut.numpy()
    assert (lut[-1] == 0.0).all()
    allc = np.concatenate([np.exp(w), np.exp(logf)], axis=1)
    if narrow:
        allc = allc[rows]
    first = [expand_w.index(c) if c in expand_w
             else w.shape[1] + expand_gl.index(c) for c in range(C)]
    np.testing.assert_array_max_ulp(np.exp(lut[:-1]), allc[:, first], 1)
    n = lut.shape[0]
    T = np.exp(lut)
    planes = tabs[3].astype(np.float64)[:, :n]
    df = (planes[:C] + planes[C : 2 * C]) * np.exp2(planes[2 * C :])
    np.testing.assert_allclose(T.T, df, rtol=1e-13)
    g = tab.g_table.numpy()
    assert g.shape == (3 * 4 + 3, 31) and g.dtype == np.float64
    np.testing.assert_array_equal(g[:12, :30].T, gps.reshape(30, 12))
    np.testing.assert_array_equal(g[12:, :30].T, gp0)
    np.testing.assert_array_equal(g[:, 30], [1, 0, 0] * 5)


# ---------------------------------------------------------------- front

@pytest.mark.parametrize("seed,grid,U", [(0, [0.0, 0.5], 3),
                                         (1, GRID5, 5)])
def test_front_plain_matches_jax(seed, grid, U):
    """front_exact_plain against the JAX exact front (pair-code gather,
    _mixture_table_df, _gl_table_df; XLA, df32): t and gl within 1e-12
    relative; masked slots get gl == (1, 0, 0) and padded slots t == 1
    exactly."""
    import jax.numpy as jnp

    from demuxlet_tpu.ops import pallas_pair_exact as PE

    codes, idx, msk, gps, _ = _workload(seed, U=U)
    w, logf = luts.pair_lut(grid, 40), luts.singlet_lut(40)
    _, _, tabs, meta = PE.split_tables(gps, TE.compute_gp0(gps), w, logf)
    C, _, gsel = meta
    tab = TE.place(TE.exact_host_tables(gps, grid, 40, None), CPU)
    n_rows = w.shape[0] + 1
    c = np.minimum(codes.astype(np.int32), n_rows - 1)
    mh, ml, ef = PE._pair_prod_gather(tuple(map(jnp.asarray, tabs[:3])),
                                      jnp.asarray(c), n_rows)
    th, tl = PE._mixture_table_df(
        mh, ml, ef, axis=0,
        chan_mask=np.asarray(tab.cmask)[:, None, None])
    gh, gl_ = PE._gl_table_df(*(jnp.stack([x[i] for i in gsel])
                                for x in (mh, ml, ef)))
    want_t = np.asarray(th, np.float64) + np.asarray(tl, np.float64)
    want_gl = np.asarray(gh, np.float64) + np.asarray(gl_, np.float64)
    t, gl = TF.front_exact(torch.from_numpy(codes.astype(np.int32)),
                           tab.lut, torch.from_numpy(msk), tab.cmask,
                           tab.gsel)
    assert t.shape == (C, 16, 128) and gl.shape == (3, 16, 128)
    np.testing.assert_allclose(t.numpy(), want_t, rtol=1e-12)
    np.testing.assert_allclose(gl.numpy()[:, msk], want_gl[:, msk],
                               rtol=1e-12)
    assert (gl.numpy()[:, ~msk] == np.array([[1.0], [0.0], [0.0]])).all()
    empty = (codes == 255).all(axis=-1)
    assert empty.any() and (t.numpy()[:, empty] == 1.0).all()


def _hot_csr(rng, n_cells, n_snps, hot_depth, nsnps_total=20_000):
    """A pileup of n_snps sorted distinct SNPs per cell, 1-2 UMIs per
    slot, allele == 2 holes (so some slots keep real codes only in deep
    lanes: the packer's tail-only marker slots) and two PCR-hot slots of
    hot_depth UMIs per cell (the wire's deep-lane tail)."""
    obs = []
    for c in range(n_cells):
        snps = np.sort(rng.choice(nsnps_total, size=n_snps, replace=False))
        depth = 1 + (rng.random(n_snps) < 0.2)
        depth[rng.choice(n_snps, size=2, replace=False)] = hot_depth
        cells = np.full(int(depth.sum()), c)
        al = rng.integers(0, 3, size=len(cells))
        bq = np.where(rng.random(len(cells)) < 0.8, 37, 23)
        obs.append(np.stack([cells, np.repeat(snps, depth), al, bq], 1))
    obs = np.concatenate(obs)
    return CsrPileup.from_arrays(
        ["S0", "S1"], nsnps_total, ["B%03d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8))


def _packed_v2(packer, csr, cfg):
    """(wire (B, W) int32, meta) of all of csr's cells from the Python
    packer (host/wire.pack_wire_block) or the native one
    (native/prep.pack_block_v2)."""
    cells = list(range(csr.nbcs))
    if packer == "python":
        return TWH.pack_wire_block(*build_codes_block(csr, cells, 40), cfg)
    from demuxlet_tpu_torch.native import prep

    if not prep.available():
        pytest.skip("the native packer is not built")
    return prep.pack_block_v2(csr, cells, cfg, cap_bq=40)


def _tail_only_slots(full, U0, cfg):
    """Slots whose dense lanes hold only the marker and whose deep lanes
    hold real codes."""
    return ((full[..., 0] == cfg.marker)
            & (full[..., 1:U0] == cfg.none).all(dim=-1)
            & (full[..., U0:] < cfg.n_real).any(dim=-1))


@pytest.mark.parametrize("packer", ["python", "native"])
@pytest.mark.parametrize("tw,n_cells,n_snps,hot,u_cap", [
    (16, 40, 60, 9, 1),
    (24, 6, 1200, 40, 1),
    (32, 4, 140, 300, 1),
    (16, 12, 60, 4, 8),  # every lane dense: K2p == 0
])
def test_front_plain_parts_equal_rebuilt_lanes(packer, tw, n_cells, n_snps,
                                               hot, u_cap):
    """front_exact_plain on a v2 wire's parts (dense lanes and the sorted
    deep-lane tail, as exact_block passes them) is bit-equal to
    front_exact_plain on the full lanes rebuild_lanes makes, on blocks
    from both packers at tail widths 16, 24 and 32 (tail-only marker
    slots among them) and on a block without a tail (K2p == 0)."""
    rng = np.random.default_rng(tw + n_cells)
    csr = _hot_csr(rng, n_cells, n_snps, hot)
    cfg = TWH.WireCfg(TWH.choose_cfg(csr, 40).dict_codes, 4, 8, u_cap=u_cap,
                      adaptive=False)
    buf, meta = _packed_v2(packer, csr, cfg)
    _, S, U, U0, K2p, _, _, _, _, got_tw = meta
    dense, tail, n_deep, _, msk = TW.decode((torch.from_numpy(buf),), meta)
    assert n_deep == U - U0
    if u_cap >= U:
        assert K2p == 0 and tail is None
        full = dense
    else:
        assert got_tw == tw and K2p > 0
        full = TW.rebuild_lanes(dense, *tail, n_deep, cfg.none)
        assert bool(_tail_only_slots(full, U0, cfg).any())
        tail = tuple(x.to(torch.int32).contiguous() for x in tail)
    # the dense lanes' mask is the full lanes': a tail-only slot carries
    # the marker in lane 0
    assert torch.equal(msk, (full != cfg.none).any(dim=-1))
    tab = TE.place(TE.exact_host_tables(np.full((2, 2, 3), 1 / 3), GRID5,
                                        40, cfg), CPU)
    args = (tab.lut, msk, tab.cmask, tab.gsel)
    t, gl = TF.front_exact_plain(dense.to(torch.int32), *args, tail, U - U0)
    want_t, want_gl = TF.front_exact_plain(full, *args)
    assert t.shape == (tab.lut.shape[1], buf.shape[0], S)
    assert torch.equal(t, want_t) and torch.equal(gl, want_gl)


def test_exact_block_on_v2_wire_matches_jax():
    """exact_block on a v2 wire, its front reading the dense lanes and the
    deep-lane tail as they arrive, against the JAX package on the same
    buffer: the JAX exact front (its own decode, pair-code gather,
    _mixture_table_df, _gl_table_df) within 1e-12 relative on t and gl,
    and the JAX f64 likelihood kernels on the block it decodes within
    1e-9 absolute, at the engine's options (the mirrored plane an exact
    copy)."""
    import jax.numpy as jnp

    from demuxlet_tpu.ops import pallas_pair as PP
    from demuxlet_tpu.ops import pallas_pair_exact as PE

    rng = np.random.default_rng(21)
    csr = _hot_csr(rng, 12, 50, 12, nsnps_total=400)
    cfg = TWH.WireCfg(TWH.choose_cfg(csr, 40).dict_codes, 4, 8, u_cap=1,
                      adaptive=False)
    buf, meta = _packed_v2("python", csr, cfg)
    assert meta[4] > 0  # a deep-lane tail
    grid = [0.0, 0.5]
    gps = rng.dirichlet(np.ones(3), size=(400, 3))
    tab = TE.place(TE.exact_host_tables(gps, grid, 40, cfg), CPU)
    fronts = []

    def front(*a):
        fronts.append(a)
        return TF.front_exact(*a)

    got = TF.exact_block(TW.decode((torch.from_numpy(buf),), meta), tab, 2,
                         3, a0_sep=True, sym_a=1, front_fn=front)
    (dense, lut, msk, cmask, gsel, tail, n_deep), = fronts
    assert tail is not None and n_deep == meta[2] - meta[3]
    assert dense.shape[2] == meta[3] < meta[2]
    t, gl = TF.front_exact(dense, lut, msk, cmask, gsel, tail, n_deep)

    w, logf = luts.pair_lut(grid, 40), luts.singlet_lut(40)
    _, _, tabs, meta_t = PE.split_tables(
        gps, TE.compute_gp0(gps), w, logf, rows=cfg.dict_codes)
    codes, jidx, jmsk = PP._unpack_wire_v2(jnp.asarray(buf), meta)
    n_rows = len(cfg.dict_codes) + 1
    c = jnp.minimum(codes.astype(jnp.int32), n_rows - 1)
    mh, ml, ef = PE._pair_prod_gather(tuple(map(jnp.asarray, tabs[:3])), c,
                                      n_rows)
    th, tl = PE._mixture_table_df(
        mh, ml, ef, axis=0, chan_mask=np.asarray(tab.cmask)[:, None, None])
    gh, gl_ = PE._gl_table_df(*(jnp.stack([x[i] for i in meta_t[2]])
                                for x in (mh, ml, ef)))
    m = np.asarray(jmsk)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(th, np.float64) + np.asarray(tl, np.float64),
        rtol=1e-12)
    np.testing.assert_allclose(
        gl.numpy()[:, m],
        (np.asarray(gh, np.float64) + np.asarray(gl_, np.float64))[:, m],
        rtol=1e-12)
    want = _jax_f64(np.asarray(codes), np.asarray(jidx), m, gps, grid,
                    rows=cfg.dict_codes)
    for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        assert g.shape == ref.shape, name
        assert np.abs(g.numpy() - ref).max() < 1e-9, name
    plane = got[2][..., 1]
    assert torch.equal(plane, plane.transpose(1, 2))


# ---------------------------------------------------------------- pair

@pytest.mark.parametrize("V,grid,opt", [
    (3, [0.0, 0.5], True),
    (3, [0.0, 0.5], False),
    (4, GRID5, True),
    (2, [0.1, 0.3], False),
])
def test_block_plain_matches_jax_f64(V, grid, opt):
    """The exact block step with the plain K2'/K3' against the JAX f64
    likelihood kernels and their port (ops/likelihood.py) on the same
    block: within 1e-10 absolute of each; with sym_a the mirrored plane is
    an exact copy."""
    codes, idx, msk, gps, _ = _workload(V + len(grid), V=V)
    a0_sep = opt and grid[0] == 0.0
    sym_a = grid.index(0.5) if opt and 0.5 in grid else None
    got = _port_block(codes, idx, msk, gps, grid, a0_sep=a0_sep,
                      sym_a=sym_a)
    for want in (_jax_f64(codes, idx, msk, gps, grid),
                 _likelihood_f64(codes, idx, msk, gps, grid)):
        for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got,
                                want):
            assert g.dtype == torch.float64 and g.shape == ref.shape, name
            assert np.abs(g.numpy() - ref).max() < 1e-10, name
    if sym_a is not None:
        plane = got[2][..., sym_a]
        assert torch.equal(plane, plane.transpose(1, 2))


def test_block_plain_matches_jax_df32_kernel():
    """Against the JAX package's own exact block step, the df32 Pallas
    kernel K3 in interpret mode (front="pair"), at the engine's options:
    within 1e-9 absolute. Tiny (V=2, A=2, one 16x128 tile) to keep its
    interpret compile short."""
    import jax.numpy as jnp

    from demuxlet_tpu.ops import pallas_pair_exact as PE

    codes, idx, msk, gps, grid = _workload(5, U=2, V=2, A=2, NS=50)
    gps_pair, gp0_pair, tabs, meta = PE.split_tables(
        gps, TE.compute_gp0(gps), luts.pair_lut(grid, 40),
        luts.singlet_lut(40))
    want = PE.demux_block_exact(
        jnp.asarray(codes), jnp.asarray(idx), jnp.asarray(msk),
        tuple(map(jnp.asarray, gps_pair)), tuple(map(jnp.asarray, gp0_pair)),
        tuple(map(jnp.asarray, tabs)), meta, 2, 2, interpret=True,
        a0_zero=True, sym_a=1, front="pair")
    got = _port_block(codes, idx, msk, gps, grid, a0_sep=True, sym_a=1)
    for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        assert np.abs(g.numpy() - PE.combine(ref)).max() < 1e-9, name


def test_all_padding_block_is_exactly_zero():
    """No observation anywhere: every LLK is exactly 0 (t == 1, neutral
    rows, gl == (1, 0, 0))."""
    codes = np.full((16, 128, 2), 255, dtype=np.uint8)
    idx = np.zeros((16, 128), np.int32)
    msk = np.zeros((16, 128), bool)
    gps = np.random.default_rng(0).dirichlet(np.ones(3), size=(10, 4))
    for opt in (False, True):
        out = _port_block(codes, idx, msk, gps, [0.0, 0.5], a0_sep=opt,
                          sym_a=1 if opt else None)
        for x in out:
            assert bool((x == 0).all())


# ---------------------------------------------------------------- engine

def _swap_equal(got, want, V, A, sym_a):
    """best_flat equal, or the (j,k) <-> (k,j) swap on the alpha == 0.5
    plane (the port mirrors it, the JAX f64 path computes both)."""
    j, k, a = want // (V * A), (want // A) % V, want % A
    return (got == want) | ((a == sym_a) & (got == k * V * A + j * A + a))


@pytest.mark.parametrize("wire", ["v1", "v2"])
def test_run_compact_matches_jax_run(monkeypatch, wire):
    """Port exact run_compact, on the wire v2 or on the v1 forms (past a
    slot limit cut below the pileup's blocks), against the JAX engine's
    exact run() (XLA f64) + compact_from_result on a PCR-hot pileup (deep
    UMI lanes): floats within 1e-9 absolute, integer fields equal
    (best_flat modulo the alpha == 0.5 swap)."""
    from demuxlet_tpu.models import decision as JD
    from demuxlet_tpu.models import engine as JE
    from demuxlet_tpu_torch.models import blocks as TB
    from test_torch_engine import _pcr_hot_csr

    if wire == "v1":
        monkeypatch.setattr(TB, "SLOT_LIMIT", 127)
    grid = [0.0, 0.5]
    csr, gps = _pcr_hot_csr(17)
    port = TE.DemuxEngine(gps, grid, cell_block=16, device=CPU)
    assert port.mode == "exact"
    l_t, l0_t, c_t = port.run_compact(csr, doublet_prior=0.5)
    assert (port._cfg is None) == (wire == "v1")
    csr_j, _ = _pcr_hot_csr(17)
    res = JE.DemuxEngine(gps, grid, cell_block=16).run(csr_j)
    c_j = JD.compact_from_result(res.llk_ab, res.llk_00, grid, 0.5)
    assert np.abs(l_t - res.llks).max() < 1e-9
    assert np.abs(l0_t - res.llk0s).max() < 1e-9
    for name in ("sing_col", "llk_00", "max_llk", "max_sing2", "pair_llk12",
                 "sum_single", "sum_double"):
        got, want = getattr(c_t, name), getattr(c_j, name)
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert np.abs(got - want).max() < 1e-9, name
    for name in ("i_sing1", "i_sing2"):
        np.testing.assert_array_equal(getattr(c_t, name), getattr(c_j, name))
    same = _swap_equal(c_t.best_flat, c_j.best_flat, 3, 2, 1)
    assert same.all()
    swapped = c_t.best_flat != c_j.best_flat
    # pair_llk10/20 follow the chosen (j, k): equal, or each other's
    for a, b in (("pair_llk10", "pair_llk20"), ("pair_llk20", "pair_llk10")):
        got = getattr(c_t, a)
        want = np.where(swapped, getattr(c_j, b), getattr(c_j, a))
        assert np.abs(got - want).max() < 1e-9, a


def test_llks_match_oracle():
    """Exact engine blocks (the plain K2'/K3' through exact_block) against
    the oracle's pass1_singlet and pass2_cell: within 1e-9 absolute, every
    (j, k, alpha) channel."""
    from demuxlet_tpu.host.csr import CsrPileup
    from oracle.numpy_oracle import (
        PileupData,
        compute_gp0s,
        pass1_singlet,
        pass2_cell,
    )

    rng = random.Random(4)
    nv, nsnps, grid = 4, 40, [0.0, 0.1, 0.2, 0.3, 0.5]
    g = np.random.RandomState(4).dirichlet([2, 2, 2], size=(nsnps, nv))
    scl = PileupData([f"S{i}" for i in range(nv)], [g[i] for i in range(nsnps)])
    for c in range(9):
        scl.add_cell(f"BC{c:03d}")
        for _ in range(60):
            scl.cell_totl[c] += 1
            scl.add_read(rng.randrange(nsnps), c, f"U{rng.randrange(10000)}",
                         rng.choice([0, 0, 1, 1, 2]), rng.randrange(13, 41))
    gps = np.stack(scl.snp_gps)
    eng = TE.DemuxEngine(gps, grid, cell_block=4, device=CPU)
    llks, llk0s, _ = eng.run_compact(scl, 0.5)
    gp0s = compute_gp0s(scl)
    o_llks, o_llk0s = pass1_singlet(scl, gp0s)
    assert np.abs(llks - o_llks).max() < 1e-9
    assert np.abs(llk0s - o_llk0s).max() < 1e-9
    csr, cfg = eng._kernel_setup(CsrPileup.from_pileup(scl), None)
    tab = eng._tables("exact")
    blocks, pads = eng._blocks(csr.nbcs, csr)
    n = 0
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        blk = eng._packer.pack(csr, cells, cfg, pad)
        _, _, ab, z0 = TF.exact_block(
            TW.decode(TE._h2d(blk.bufs, CPU), blk.meta), tab, len(grid), nv,
            a0_sep=True, sym_a=4)
        for r, c in enumerate(cells):
            o_ab, _, o_00 = pass2_cell(scl, gp0s, c, grid)
            assert np.abs(ab[r].numpy() - o_ab).max() < 1e-9
            assert np.abs(z0[r].numpy() - o_00).max() < 1e-9
            n += 1
    assert n == scl.nbcs


def test_cli_default_mode_matches_jax_cli_exact(tmp_path):
    """The port CLI with no --mode (exact, the default) against the JAX
    CLI --mode exact, both --device cpu on one BAM/VCF: .single and .sing2
    byte-identical, .best equal after canonicalize_best."""
    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli as tcli
    from fixtures import random_workload, write_bam, write_vcf
    from parity_utils import canonicalize_best

    contigs, names, variants, reads, _ = random_workload(
        random.Random(31), n_cells=24, n_snps=50, n_samples=4,
        reads_per_cell=70)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu",
            "--mesh", "none"]
    assert tcli.main(base + ["--out", str(tmp_path / "t")]) == 0
    assert jcli.main(base + ["--mode", "exact",
                             "--out", str(tmp_path / "j")]) == 0

    def read(out, ext):
        with open(str(tmp_path / out) + ext) as fh:
            return fh.read().splitlines()

    for ext in (".single", ".sing2"):
        assert read("t", ext) == read("j", ext), ext
    best = read("t", ".best")
    assert len(best) == 25
    assert canonicalize_best(best) == canonicalize_best(read("j", ".best"))


def _k3_inputs(B, S, V, grid, device, seed=3):
    """K3''s inputs for a card or CPU test: t and gl from the plain front
    on random codes (~20% masked slots), flat-Dirichlet g rows for V
    samples and the background with neutral rows on masked slots; and the
    tables' expand."""
    rng = np.random.default_rng(seed)
    tab = TE.place(TE.exact_host_tables(np.full((4, V, 3), 1 / 3), grid,
                                        40, None), device)
    codes = rng.integers(0, 82, size=(B, S, 2)).astype(np.int32)
    codes[rng.random((B, S, 2)) < 0.3] = 255
    msk = rng.random((B, S)) < 0.8
    t, gl = TF.front_exact_plain(torch.from_numpy(codes).to(device),
                                 tab.lut, torch.from_numpy(msk).to(device),
                                 tab.cmask, tab.gsel)
    g = rng.dirichlet(np.ones(3), size=(V + 1, B, S))
    g[:, ~msk] = np.array([1.0, 0.0, 0.0])
    g = torch.from_numpy(np.ascontiguousarray(
        g.transpose(0, 3, 1, 2).reshape(3 * V + 3, B, S))).to(device)
    return t, g, gl, tab.expand


def test_k3_fits_refuses_exactly_the_large_v1_grids():
    """k3_fits over every (V, A) with V*V*A <= 384 on linspace(0, 0.5, A)
    grids (C the deduplicated t channels): K3''s stages refuse 220 grids,
    all at V=1, the first at A=162 (C=716), the last V=1/A=384 (C=1601);
    every other pool fits."""
    from demuxlet_tpu_torch.kernels.pair_exact import k3_fits
    from demuxlet_tpu_torch.ops.pair import dedup_channels

    refused = []
    for V in range(1, 21):
        for A in range(1, 384 // (V * V) + 1):
            C = len(dedup_channels(np.linspace(0, 0.5, A).tolist())[0])
            for a0_sep in (True, False):
                if not k3_fits(V, A, C, a0_sep):
                    refused.append((V, A, C, a0_sep))
    assert len(refused) == 2 * 220
    assert {r[0] for r in refused} == {1}
    assert min(refused)[:3] == (1, 162, 716)
    assert max(refused)[:3] == (1, 384, 1601)
    assert not k3_fits(21, 1, 30, True)


def test_refused_k3_shape_takes_the_tiled_route(monkeypatch):
    """pair_exact at V=1, A=200 (stages K3' refuses) goes to
    pair_exact_tiled with a forced plan (K7' + K6', here their plain
    versions): within 1e-12 absolute of pair_exact_plain; a pool that fits
    stays on K3''s route."""
    grid = np.linspace(0, 0.5, 200).tolist()
    t, g, gl, expand = _k3_inputs(3, 64, 1, grid, CPU, seed=4)
    args = (t, g, gl, 1, 200, True, 199, expand)
    calls = []
    tiled = TP.pair_exact_tiled
    monkeypatch.setattr(TP, "pair_exact_tiled", lambda *a, **k: (
        calls.append(k.get("force")), tiled(*a, **k))[1])
    got = TP.pair_exact(*args)
    assert calls == [True]
    want = TP.pair_exact_plain(*args)
    for x, y in zip(got, want):
        assert x.shape == y.shape
        assert float((x - y).abs().max()) < 1e-12
    grid = np.linspace(0, 0.5, 161).tolist()
    t, g, gl, expand = _k3_inputs(2, 32, 1, grid, CPU)
    TP.pair_exact(t, g, gl, 1, 161, True, 160, expand)
    assert calls == [True]


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K2' and K3' have no CPU mode)")
    return torch.device("cuda", 0)


# the 4-code wire-v2 dictionary of the engine's main path (a 5-row LUT)
_V2_CFG = TWH.WireCfg((23, 37, 41 + 23, 41 + 37), 4, 8)


def _v2_parts(rng, B, S, U, U0, k2p_floor, device):
    """Wire-v2 parts of a random block on ``_V2_CFG``: 1 + Poisson(0.3)
    UMIs per slot, 3% PCR-hot slots of U/2..U, 20% padded slots and 30%
    holes among the UMIs (tail-only marker slots), split at U0 dense lanes
    by the packer's rule (host/wire._split_tail; K2p at least k2p_floor:
    padded tails). Returns (dense (B,S,U0), (tpos, tcode) (B,K2p), msk)
    int32/bool on device, positions flattened as ops/wire.decode does."""
    cfg = _V2_CFG
    n = 1 + rng.poisson(0.3, size=(B, S))
    hot = rng.random((B, S)) < 0.03
    n[hot] = rng.integers(U // 2, U + 1, size=int(hot.sum()))
    n[rng.random((B, S)) < 0.2] = 0
    wc = np.full((B, S, U), cfg.none, np.uint8)
    occ = np.arange(U) < n[..., None]
    wc[occ] = rng.integers(0, cfg.n_real, size=int(occ.sum()))
    wc[occ & (rng.random((B, S, U)) < 0.3)] = cfg.none
    dense, U0, K2p, tw, tpos, tcode = TWH._split_tail(
        wc, cfg, u0_pin=U0, k2p_floor=k2p_floor)
    if tw == 24:
        tpos = tpos[0].astype(np.int64) * (U - U0) + tpos[1]
    dev = lambda x: torch.from_numpy(
        np.ascontiguousarray(x).astype(np.int32)).to(device)
    dense = dev(dense)
    return dense, (dev(tpos), dev(tcode)), (dense != cfg.none).any(dim=-1)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,U,grid,cap,lut_kb,parts", [
    (64, 256, 3, GRID5, 40, 11, None),
    (40, 384, 2, [0.0, 0.5], 40, 3, None),
    (16, 130, 20, GRID5, 126, 35, None),  # PCR-deep lanes, 255-row LUT
    (8, 100, 2, np.linspace(0, 0.5, 12).tolist(), 63, 49, None),  # > 48 KB
    (8, 128, 2, np.linspace(0, 0.5, 24).tolist(), 63, 99, None),  # via L1
    (8, 128, 2, np.linspace(0, 0.5, 96).tolist(), 126, 798, None),
    # wire-v2 parts (U0, K2p floor) on a 5-row LUT
    (16, 512, 64, GRID5, 40, 0, (1, 16)),
    (16, 512, 64, GRID5, 40, 0, (2, 16)),
    (16, 256, 64, [0.0, 0.5], 40, 0, (8, 16)),
    (8, 256, 64, GRID5, 40, 0, (2, 8192)),  # padded tail past TAIL_SMEM_MAX
    (4, 4096, 64, GRID5, 40, 0, (2, 16)),  # the deepest pad: tail width 24
    (4, 300, 300, [0.0, 0.5], 40, 0, (2, 16)),  # tail width 32
])
def test_k2_matches_plain_on_card(cuda_device, B, S, U, grid, cap, lut_kb,
                                  parts):
    """K2' against front_exact_plain on the card, with the LUT staged in
    shared memory (up to SMEM_MAX, opted in past 48 KB) or read through
    L1: the same lane-order sums, so t and gl agree to the exp's last bits
    (1e-13 relative); two launches give identical bits. On wire-v2 parts
    (dense lanes and the sorted tail, staged in shared memory or read
    through L1) the outputs also equal K2''s on the rebuilt full lanes bit
    for bit: the tail is applied in lane order."""
    from demuxlet_tpu_torch.kernels import front_exact as kernel
    from demuxlet_tpu_torch.ops.wire import rebuild_lanes

    rng = np.random.default_rng(5)
    gps = rng.dirichlet(np.ones(3), size=(20, 2))
    tab = TE.place(TE.exact_host_tables(
        gps, grid, cap, None if parts is None else _V2_CFG), cuda_device)
    R, C = tab.lut.shape
    assert R * C * 8 // 1024 == lut_kb
    tail, n_deep = None, 0
    if parts is None:
        codes = rng.integers(0, R + 2, size=(B, S, U)).astype(np.int32)
        codes[rng.random((B, S, U)) < 0.4] = 255
        msk = torch.from_numpy(rng.random((B, S)) < 0.8).to(cuda_device)
        codes = torch.from_numpy(codes).to(cuda_device)
    else:
        codes, tail, msk = _v2_parts(rng, B, S, U, *parts, cuda_device)
        n_deep = U - parts[0]
    args = (tab.lut, msk, tab.cmask, tab.gsel)
    before = kernel.launches
    t, gl = kernel.front_exact(codes, *args, tail, n_deep)
    t2, gl2 = kernel.front_exact(codes, *args, tail, n_deep)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    pt, pgl = TF.front_exact_plain(codes, *args, tail, n_deep)
    for got, want in ((t, pt), (gl, pgl)):
        err = (got - want).abs() / want.abs().clamp(min=1e-300)
        assert float(err.max()) < 1e-13
    assert torch.equal(t, t2) and torch.equal(gl, gl2)
    if parts is not None:
        full = rebuild_lanes(codes, *tail, n_deep, _V2_CFG.none)
        t3, gl3 = kernel.front_exact(full, *args)
        assert torch.equal(t, t3) and torch.equal(gl, gl3)


def edge_inputs(edge, t, g, gl, expand, rng):
    """Rewrite a card test's inputs t (C, B, S), g (3n, B, S) and gl (3, B,
    S) or None in place for an edge case of the product accumulators (f64
    or f32): "floor", every t at the +1e-6 smoothing floor (inner values
    ~1e-6, so the exponents run far); "special", cell 0 with an all-zero g
    row of sample 1 at one slot (exact-zero inner values: -inf) and cell 1
    with a NaN t value of the last alpha at one slot; "padding", every slot
    masked (t == 1, neutral rows): every LLK exactly 0."""
    if edge == "floor":
        t.copy_(1e-6 * (1.0 + torch.from_numpy(
            rng.random(tuple(t.shape))).to(t)))
    elif edge == "special":
        g[3:6, 0, 5] = 0.0
        t[expand[-1], 1, 7] = float("nan")
    elif edge == "padding":
        t.fill_(1.0)
        g.view(-1, 3, *g.shape[1:])[:, 0] = 1.0
        g.view(-1, 3, *g.shape[1:])[:, 1:] = 0.0
        if gl is not None:
            gl[0], gl[1:] = 1.0, 0.0


def assert_close_on_card(got, want, tol=1e-9, relative=False):
    """got within tol of want, absolute or (relative) with scale
    max(1, |want|), where equal infinities and NaN against NaN count as
    equal (the plain version's log of 0 or NaN)."""
    got, want = got.double(), want.double()
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    err = (got - want).abs()
    if relative:
        err = err / want.abs().clamp(min=1.0)
    err = torch.where(same, torch.zeros_like(got), err)
    assert not bool(torch.isnan(err).any())
    assert float(err.max()) < tol


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid,edge", [
    (64, 256, 8, GRID5, None),
    (40, 384, 8, [0.0, 0.5], None),
    (33, 200, 13, [0.0, 0.5], None),
    (32, 128, 3, [0.1, 0.3, 0.5], None),
    (16, 130, 2, [0.0], None),  # separable plane only; S not a warp multiple
    (8, 160, 19, [0.5], None),  # the V <= 20 instantiation, symmetric plane
    (8, 128, 1, [0.0, 0.25, 0.5], None),
    (4, 128, 2, np.linspace(0, 0.5, 96).tolist(), None),  # V*V*A == 384
    (4, 8192, 8, GRID5, None),  # deep: the exponents run far
    (8, 1000, 8, GRID5, "floor"),  # S not a multiple of the 64-slot chunk
    (6, 200, 13, [0.0, 0.5], "floor"),
    (4, 256, 8, GRID5, "special"),
    (4, 130, 13, [0.0, 0.5], "special"),
    (4, 200, 8, GRID5, "padding"),
])
def test_k3_matches_plain_on_card(cuda_device, B, S, V, grid, edge):
    """K3' against pair_exact_plain on the card: LLKs within 1e-9
    absolute (equal infinities and NaNs match), two launches give
    identical bits (no atomics), the alpha == 0.5 plane is exactly
    symmetric; an all-padding block gives exact zeros."""
    from demuxlet_tpu_torch.kernels import pair_exact as kernel

    A = len(grid)
    t, g, gl, expand = _k3_inputs(B, S, V, grid, cuda_device)
    edge_inputs(edge, t, g, gl, expand, np.random.default_rng(S))
    a0_sep = grid[0] == 0.0
    sym_a = grid.index(0.5) if 0.5 in grid else None
    before = kernel.launches
    got = TP.pair_exact(t, g, gl, V, A, a0_sep, sym_a, expand)
    again = TP.pair_exact(t, g, gl, V, A, a0_sep, sym_a, expand)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2
    want = TP.pair_exact_plain(t, g, gl, V, A, a0_sep, sym_a, expand)
    for x, y, z in zip(got, want, again):
        assert_close_on_card(x, y)
        assert torch.equal(x.nan_to_num(), z.nan_to_num())
        if edge == "padding":
            assert bool((x == 0).all())
    if sym_a is not None:
        plane = got[0][..., sym_a].nan_to_num()
        assert torch.equal(plane, plane.transpose(1, 2))
    if edge == "special":
        assert bool(torch.isneginf(got[2][0, 1])) and bool(
            torch.isnan(got[0][1, :, :, A - 1]).all())


@pytest.mark.cuda
def test_k3_fits_matches_the_library_on_card(cuda_device):
    """k3_fits (pure Python) equals K3''s own answer,
    dmx_pair_exact_smem != 0, over a sweep of V, A and C that crosses the
    boundary of every chunk size."""
    from demuxlet_tpu_torch.kernels import pair_exact as kernel

    for V in (1, 2, 3, 4, 5, 8, 9, 13, 16, 17, 20, 21):
        for A in (1, 2, 5, 96, 161, 162, 200, 384):
            for C in range(1, 2002, 5):
                a0_sep = C % 2 == 0
                assert kernel.k3_fits(V, A, C, a0_sep) == (
                    kernel.smem_bytes(V, A, C, a0_sep) != 0), (V, A, C)


@pytest.mark.cuda
def test_refused_k3_shape_runs_on_k7_k6_on_card(cuda_device):
    """pair_exact at V=1, A=200, a shape K3''s stages refuse, runs on K7'
    and K6' (one launch each, none of K3') within 1e-9 absolute of
    pair_exact_plain."""
    from demuxlet_tpu_torch.kernels import extras_exact as k6
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.kernels import pair_tiled_exact as k7

    grid = np.linspace(0, 0.5, 200).tolist()
    t, g, gl, expand = _k3_inputs(8, 256, 1, grid, cuda_device)
    args = (t, g, gl, 1, 200, True, 199, expand)
    assert not k3.k3_fits(1, 200, t.shape[0], True)
    before = (k3.launches, k7.launches, k6.launches)
    got = TP.pair_exact(*args)
    torch.cuda.synchronize()
    assert (k3.launches, k7.launches, k6.launches) == (
        before[0], before[1] + 1, before[2] + 1)
    for x, y in zip(got, TP.pair_exact_plain(*args)):
        assert x.shape == y.shape
        assert_close_on_card(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,U,V,grid,narrow", [
    (32, 256, 3, 8, GRID5, False),
    (16, 512, 64, 8, GRID5, True),  # a PCR-hot block's full lanes, 5-row LUT
    (20, 130, 4, 3, [0.0, 0.5], False),
])
def test_exact_block_matches_likelihood_on_card(cuda_device, B, S, U, V,
                                                grid, narrow):
    """The exact block step through K2' and K3' on the card against the
    port's dense f64 likelihood kernels (ops/likelihood.py) on the card:
    within 1e-9 absolute, every (j, k, alpha) channel. On a wire-v2 style
    dictionary of 4 codes when narrow, as the engine's main path runs."""
    from demuxlet_tpu.host.wire import WireCfg
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3

    codes, idx, msk, gps, _ = _workload(B + U, B=B, S=S, U=U, V=V)
    rows = [23, 37, 41 + 23, 41 + 37] if narrow else None
    if narrow:
        codes = np.where(codes == 255, 255, codes % 4).astype(np.uint8)
        codes[:, :, 8:][np.random.default_rng(0).random(
            codes[:, :, 8:].shape) < 0.97] = 255
    cfg = WireCfg(tuple(rows), 4, 8) if narrow else None
    tab = TE.place(TE.exact_host_tables(gps, grid, 40, cfg), cuda_device)
    before = (k2.launches, k3.launches)
    got = TF.exact_block(_parts(codes, idx, msk, cuda_device), tab,
                         len(grid), V, a0_sep=True, sym_a=grid.index(0.5))
    torch.cuda.synchronize()
    assert (k2.launches, k3.launches) == (before[0] + 1, before[1] + 1)
    want = _likelihood_f64(codes, idx, msk, gps, grid, rows=rows,
                           device=cuda_device)
    for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        assert g.shape == ref.shape, name
        assert np.abs(g.cpu().numpy() - ref).max() < 1e-9, name
