"""Exact mode of the port on large pools (V*V*A > 384) against the JAX
package and the oracle: the tile plan, the plain versions of K7' (tiled
f64 pair search) and K6' (its O(V) channels) through the exact block step,
exact run_compact and the CLI's default mode; and, on a card, K7' and K6'
against the port's dense f64 likelihood kernels.

JAX is imported inside the tests that compare with it, so the ``cuda``
tests also collect where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_tiled_exact.py``.
No new Pallas-interpret df32 shape is compiled: the references are the
JAX f64 likelihood kernels (XLA), the JAX engine's exact run() and the
oracle."""

import random

import numpy as np
import pytest
import torch

from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops import pair_tiled as PT
from test_torch_exact import _jax_f64, _k3_inputs, _likelihood_f64, \
    _port_block, _swap_equal, _workload, assert_close_on_card, edge_inputs

torch.set_num_threads(2)

CPU = torch.device("cpu")


def _grid(A):
    return np.linspace(0.0, 0.5, A).tolist()


# ---------------------------------------------------------------- plan

@pytest.mark.parametrize("A", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("vs", [(2, 17), (17, 29), (29, 41), (41, 65)])
def test_plan_covers_every_channel_once(A, vs):
    """For V in range(*vs) past the unrolled cap (V = 9..64, and V = 7, 8 on
    8-tiles at A = 8): every (j, k, alpha) channel of a non-separable alpha
    is written by exactly one tile, either directly or, on the symmetric
    plane, as the mirror of (k, j); the separable alpha == 0 plane by none.
    The symmetric plane takes the upper triangle of the tiles, n(n+1)/2
    items for n tiles an axis (10 at V=64 on 16-tiles). With and without
    a0_sep/sym_a."""
    for V in range(*vs):
        for a0_sep, sym in ((True, True), (False, True), (False, False)):
            grid = _grid(A)
            sym_a = grid.index(0.5) if sym and 0.5 in grid else None
            plan = PT.plan_tiles(V, A, a0_sep, sym_a)
            if V * V * A <= 384:
                assert plan is None
                continue
            assert plan.tile == (16 if V > 8 else 8)
            hits = np.zeros((V, V, A), np.int64)
            for j0, k0, a0, na, is_sym in plan.items:
                assert j0 % plan.tile == 0 and k0 % plan.tile == 0
                for a in plan.alist[a0 : a0 + na]:
                    assert (a == sym_a) == bool(is_sym)
                    for j in range(j0, min(j0 + plan.tile, V)):
                        for k in range(k0, min(k0 + plan.tile, V)):
                            if is_sym and k < j:
                                continue
                            hits[j, k, a] += 1
                            if is_sym and k > j:
                                hits[k, j, a] += 1
            tiled = [a for a in range(A) if not (a0_sep and a == 0)]
            assert sorted(plan.alist) == tiled
            n_t = -(-V // plan.tile)
            n_sym = n_t * (n_t + 1) // 2 if sym_a in tiled else 0
            assert sum(it[4] for it in plan.items) == n_sym
            if V == 64 and n_sym:
                assert (plan.tile, n_sym) == (16, 10)
            assert (hits[..., tiled] == 1).all()
            if a0_sep:
                assert (hits[..., 0] == 0).all()
            assert len(PT.extras_keys(V, A, a0_sep)) == (
                V + 1 + (2 * V + 2 if a0_sep else 0) + len(tiled))


# ---------------------------------------------------------------- block

CASES = [(16, 2), (17, 3), (20, 2), (20, 1), (32, 5)]


@pytest.mark.parametrize("V,A", CASES)
def test_block_plain_matches_jax_f64(V, A):
    """The exact block step on a large pool (plain K7' + K6' through
    exact_block) against the JAX f64 likelihood kernels and their port
    (ops/likelihood.py) on the same block (B=8, S=128): within 1e-10
    absolute of each; the mirrored alpha == 0.5 plane is an exact copy.
    (20, 1) is the single-point alpha == 0 grid, where no tile runs and
    K6' carries every channel."""
    grid = _grid(A)
    assert V * V * A > 384
    codes, idx, msk, gps, _ = _workload(V * 10 + A, B=8, S=128, V=V)
    sym_a = grid.index(0.5) if 0.5 in grid else None
    got = _port_block(codes, idx, msk, gps, grid, a0_sep=True, sym_a=sym_a)
    for want in (_jax_f64(codes, idx, msk, gps, grid),
                 _likelihood_f64(codes, idx, msk, gps, grid)):
        for name, g, ref in zip(("llk", "llk0", "llk_ab", "llk_00"), got,
                                want):
            assert g.dtype == torch.float64 and g.shape == ref.shape, name
            assert np.abs(g.numpy() - ref).max() < 1e-10, name
    if sym_a is not None:
        plane = got[2][..., sym_a]
        assert torch.equal(plane, plane.transpose(1, 2))


@pytest.mark.parametrize("V,A,tile", [(17, 3, 16), (20, 2, 16), (12, 3, 16),
                                      (7, 8, 8)])
def test_tiled_plain_matches_unrolled_plain(V, A, tile):
    """pair_exact_tiled (plain K7' + K6' and the reassembly) against the
    unrolled K3''s plain version on the same inputs, separable plane and
    symmetric plane on and off: within 1e-12 absolute. Each pool is planned
    on the given tile extent with a ragged edge (V = 7 on 8-tiles)."""
    rng = np.random.default_rng(V + A)
    B, S = 4, 64
    t = torch.from_numpy(rng.random((A * 9, B, S)) + 0.05)
    g = torch.from_numpy(np.ascontiguousarray(rng.dirichlet(
        np.ones(3), size=(V + 1, B, S)).transpose(0, 3, 1, 2).reshape(
            3 * V + 3, B, S)))
    gl = torch.from_numpy(np.ascontiguousarray(
        rng.dirichlet(np.ones(3), size=(B, S)).transpose(2, 0, 1)))
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain

    for a0_sep, sym_a in ((True, A - 1), (False, A - 1), (False, None)):
        assert PT.plan_tiles(V, A, a0_sep, sym_a).tile == tile
        got = PT.pair_exact_tiled(t, g, gl, V, A, a0_sep, sym_a)
        want = pair_exact_plain(t, g, gl, V, A, a0_sep, sym_a)
        for x, y in zip(got, want):
            assert x.shape == y.shape
            assert float((x - y).abs().max()) < 1e-12


@pytest.mark.parametrize("V,A", [(17, 3), (32, 5)])
def test_llks_match_oracle(V, A):
    """Exact engine blocks on a large pool (plain K7' + K6' through
    exact_block) against the oracle's pass1_singlet and pass2_cell: within
    1e-9 absolute, every (j, k, alpha) channel."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from oracle.numpy_oracle import (
        PileupData,
        compute_gp0s,
        pass1_singlet,
        pass2_cell,
    )

    grid = _grid(A)
    rng = random.Random(V)
    nsnps = 12
    g = np.random.RandomState(V).dirichlet([2, 2, 2], size=(nsnps, V))
    scl = PileupData([f"S{i}" for i in range(V)], [g[i] for i in range(nsnps)])
    for c in range(3):
        scl.add_cell(f"BC{c:03d}")
        for _ in range(14):
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
    from demuxlet_tpu_torch.ops.front_exact import exact_block
    from demuxlet_tpu_torch.ops.wire import decode

    n = 0
    blocks, pads = eng._blocks(csr.nbcs, csr)
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        blk = eng._packer.pack(csr, cells, cfg, pad)
        _, _, ab, z0 = exact_block(
            decode(TE._h2d(blk.bufs, CPU), blk.meta), tab, A, V,
            a0_sep=True, sym_a=grid.index(0.5))
        for r, c in enumerate(cells):
            o_ab, _, o_00 = pass2_cell(scl, gp0s, c, grid)
            assert np.abs(ab[r].numpy() - o_ab).max() < 1e-9
            assert np.abs(z0[r].numpy() - o_00).max() < 1e-9
            n += 1
    assert n == scl.nbcs


@pytest.mark.parametrize("seed,empty", [(2 ** 31 + 7, 0), (2 ** 33 + 5, 32)])
def test_run_compact_matches_plain_reference_at_64_donors(seed, empty):
    """A 64-donor pool on the default grid (the benchmark's kang64_a2
    configuration, cut to 400 SNPs): the engine's run_compact, cell_stats
    and both renders (plain K2', K7' and K6' on the CPU) against the
    benchmark's plain reference (``portbench/reference.py``): rows within
    the configuration's rows_gap limit, every rendered line equal. 96
    barcodes (15% doublets), in blocks of 32, with 32 empty droplets in
    the second case."""
    import json
    import os

    from portbench import compare, generator, harness, reference

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "portbench", "configs",
                           "kang64_a2.json")) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           "unfiltered.json")) as fh:
        traffic = json.load(fh)
    cfg.update(snps=400, cell_block=32)
    traffic.update(cells=96 - empty, empty=empty)
    traffic["cell_coverage"] = dict(median=60, sigma=0.6, clip=[10, 200])
    gt, gps = generator.pool_gps(cfg, seed, CPU)
    lib = generator.make_library(cfg, traffic, gt, seed, 0, CPU)
    rec, rows, texts = harness.run_job(lib, gps, cfg, CPU,
                                       harness.Spans(False))
    assert rec["route"].startswith("kernels K2' + K7' + K6'")
    ref = reference.decide(reference.llks(lib, gps, cfg, CPU), cfg)
    gap, field = compare.rows_gap(rows, ref, 64, 2)
    assert gap <= cfg["limits"]["rows_gap"], field
    stats = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                 uniq=lib.uniq, nsnp=ref["nsnp"])
    assert compare.render_lines_off(texts, rows, stats, lib.sample_ids,
                                    cfg) == cfg["limits"]["render_lines_off"]
    assert texts[0].count("\n") == 96 * 64 + 1


@pytest.mark.parametrize("a0_sep,sym", [(True, True), (False, False)])
def test_all_padding_block_is_exactly_zero(a0_sep, sym):
    """No observation anywhere on a V=20 pool: every LLK is exactly 0."""
    codes = np.full((8, 128, 2), 255, dtype=np.uint8)
    idx = np.zeros((8, 128), np.int32)
    msk = np.zeros((8, 128), bool)
    gps = np.random.default_rng(0).dirichlet(np.ones(3), size=(10, 20))
    out = _port_block(codes, idx, msk, gps, _grid(3), a0_sep=a0_sep,
                      sym_a=2 if sym else None)
    assert out[2].shape == (8, 20, 20, 3)
    for x in out:
        assert bool((x == 0).all())


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("V,A", [(16, 2), (17, 3)])
def test_run_compact_matches_jax_run(V, A):
    """Port exact run_compact on a large pool against the JAX engine's
    exact run() (XLA f64) + compact_from_result: floats within 1e-9
    absolute, integer fields equal (best_flat modulo the alpha == 0.5
    swap)."""
    from demuxlet_tpu.models import decision as JD
    from demuxlet_tpu.models import engine as JE
    from test_torch_engine import _pcr_hot_csr

    grid = _grid(A)
    csr, gps = _pcr_hot_csr(V, n_cells=24, NS=120, V=V, per_cell=(10, 30))
    port = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    l_t, l0_t, c_t = port.run_compact(csr, doublet_prior=0.5)
    csr_j, _ = _pcr_hot_csr(V, n_cells=24, NS=120, V=V, per_cell=(10, 30))
    res = JE.DemuxEngine(gps, grid, cell_block=8).run(csr_j)
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
    assert _swap_equal(c_t.best_flat, c_j.best_flat, V, A,
                       grid.index(0.5)).all()


def test_cli_default_mode_matches_jax_cli_exact(tmp_path):
    """The port CLI with no --mode (exact) on a V=16 pool on the default
    grid (V*V*A = 512: K7' + K6') against the JAX CLI --mode exact, both
    --device cpu on one BAM/VCF: .single and .sing2 byte-identical, .best
    equal after canonicalize_best."""
    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli as tcli
    from fixtures import random_workload, write_bam, write_vcf
    from parity_utils import canonicalize_best

    contigs, names, variants, reads, _ = random_workload(
        random.Random(16), n_cells=20, n_snps=60, n_samples=16,
        reads_per_cell=60)
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
    assert len(best) == 21
    assert canonicalize_best(best) == canonicalize_best(read("j", ".best"))


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K7' and K6' have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid,edge", [
    (16, 256, 32, _grid(5), None),
    (40, 384, 7, _grid(8), None),  # ragged edge, 8-tiles
    (40, 384, 17, _grid(3), None),  # ragged edge, 16-tiles
    (33, 200, 20, [0.0, 0.5], None),
    (16, 130, 20, [0.5, 0.1], None),  # no separable plane; S % 32 != 0
    (16, 128, 24, [0.0], None),  # single-point alpha == 0 grid: K6' alone
    (2, 8192, 32, [0.0, 0.5], None),  # deep: the exponents run far
    (6, 640, 64, [0.0, 0.5], None),  # 4 tiles an axis: 10 upper-triangle
    (8, 1000, 17, _grid(3), "floor"),  # S % 64 != 0 (the staging chunk)
    (4, 200, 7, _grid(8), "floor"),
    (4, 256, 32, _grid(5), "special"),
    (4, 130, 20, [0.5, 0.1], "special"),
    (4, 200, 20, [0.0, 0.5], "padding"),
])
def test_k7_k6_match_likelihood_on_card(cuda_device, B, S, V, grid, edge):
    """The tiled exact pair search through K7' and K6' on the card against
    the port's dense f64 likelihood kernels (ops/likelihood.py) on the
    card: within 1e-9 absolute, every (j, k, alpha) channel; against the
    plain versions on the card within 1e-9 (equal infinities and NaNs
    match); two launches give identical bits (no atomics) and the
    alpha == 0.5 plane is exactly symmetric. The edge cases of
    ``edge_inputs`` (inputs at the smoothing floor, exact-zero and NaN
    inner values, an all-padding block: exact zeros) rewrite t and g after
    the front, so they are held against the plain versions alone."""
    from demuxlet_tpu_torch.kernels import extras_exact as k6
    from demuxlet_tpu_torch.kernels import pair_tiled_exact as k7
    from demuxlet_tpu_torch.ops.front_exact import front_exact_plain

    A = len(grid)
    codes, idx, msk, gps, _ = _workload(V + S, B=B, S=S, U=3, V=V)
    tab = TE.place(TE.exact_host_tables(gps, grid, 40, None), cuda_device)
    a0_sep = grid[0] == 0.0
    sym_a = grid.index(0.5) if 0.5 in grid else None
    dev = lambda x: torch.from_numpy(x).to(cuda_device)
    t, gl = front_exact_plain(dev(codes.astype(np.int32)), tab.lut, dev(msk),
                              tab.cmask, tab.gsel)
    NS = tab.g_table.shape[1] - 1
    idx_n = torch.where(dev(msk), dev(idx).long(), NS).reshape(-1)
    g = tab.g_table.index_select(1, idx_n).view(-1, B, S)
    g = g.clone()
    edge_inputs(edge, t, g, gl, tab.expand, np.random.default_rng(S))
    plan = PT.plan_tiles(V, A, a0_sep, sym_a)
    before = (k7.launches, k6.launches)
    got = PT.pair_exact_tiled(t, g, gl, V, A, a0_sep, sym_a, tab.expand)
    again = PT.pair_exact_tiled(t, g, gl, V, A, a0_sep, sym_a, tab.expand)
    torch.cuda.synchronize()
    n7 = 2 if plan.items else 0
    assert (k7.launches, k6.launches) == (before[0] + n7, before[1] + 2)
    for x, y in zip(got, again):
        assert torch.equal(x.nan_to_num(), y.nan_to_num())
        if edge == "padding":
            assert bool((x == 0).all())
    if sym_a is not None:
        plane = got[0][..., sym_a].nan_to_num()
        assert torch.equal(plane, plane.transpose(1, 2))
    if edge is None:
        llk, llk0, ab, z0 = _likelihood_f64(codes, idx, msk, gps, grid,
                                            device=cuda_device)
        for name, x, ref in zip(("llk_ab", "llk_00", "llk", "llk0"), got,
                                (ab, z0, llk, llk0)):
            assert x.shape == ref.shape, name
            assert np.abs(x.cpu().numpy() - ref).max() < 1e-9, name
    if plan.items:
        want = PT.pair_tiled_plain(t, g, V, A, plan, tab.expand)
        assert_close_on_card(PT.pair_tiled(t, g, V, A, plan, tab.expand),
                             want)
    want = PT.extras_plain(t, g, gl, V, A, a0_sep, tab.expand)
    assert_close_on_card(PT.extras(t, g, gl, V, A, a0_sep, tab.expand), want)
    if edge == "special":
        assert bool(torch.isneginf(got[2][0, 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,V,grid", [
    (16, 512, 32, [0.0, 0.5]),  # 64-slot chunks: 114 stage rows
    (8, 333, 32, _grid(5)),  # S odd: 8-byte copies only
    (4, 4096, 32, [0.0, 0.5]),  # the deepest pad
    (8, 256, 1, _grid(200)),  # K3''s refused shape: rounds of alphas
    (4, 200, 70, [0.0, 0.5]),  # two rounds of samples
    (8, 130, 13, [0.1, 0.3, 0.5]),  # no separable plane, 128-slot chunks
])
def test_k6_matches_plain_on_card(cuda_device, B, S, V, grid):
    """K6' alone against extras_plain on the card: every column within
    1e-9 absolute, two launches give identical bits, one launch counted
    each; across its chunk extents, rounds of samples and of alphas, and
    slot counts that the 16-byte copies do not divide."""
    from demuxlet_tpu_torch.kernels import extras_exact as k6

    A = len(grid)
    a0_sep = grid[0] == 0.0
    t, g, gl, expand = _k3_inputs(B, S, V, grid, cuda_device)
    before = k6.launches
    got = PT.extras(t, g, gl, V, A, a0_sep, expand)
    again = PT.extras(t, g, gl, V, A, a0_sep, expand)
    torch.cuda.synchronize()
    assert k6.launches == before + 2
    assert got.shape == (B, len(PT.extras_keys(V, A, a0_sep)))
    assert torch.equal(got, again)
    assert_close_on_card(got, PT.extras_plain(t, g, gl, V, A, a0_sep,
                                              expand))
