"""The port's full-tensor ``DemuxEngine.run`` and the CLI paths on top of
it (``--write-pair``, ``--spool``, genome shards, ``--profile`` and the
dense route behind ``--exact-kernel xla``, exact ``--cap-BQ`` > 126 and
``--precision f32``) against the JAX engine and CLI on the CPU, where the
kernel route runs its kernels' plain versions; and, on a card, ``run``
against ``run_compact`` and a spooled second run that launches nothing.

JAX is imported inside the tests that compare with it, so the ``cuda``
tests also collect where JAX is absent:
``python -m pytest --noconftest -m cuda tests/test_torch_run.py``."""

import dataclasses
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from demuxlet_tpu_torch.host.csr import CsrPileup
from demuxlet_tpu_torch.models import decision as TD
from demuxlet_tpu_torch.models import engine as TE

torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXACT_TOL = 1e-9  # exact-mode contract, absolute
FAST_TOL = 2e-5  # fast-mode contract, relative with scale max(1, |x|)
INT_FIELDS = ("i_sing1", "i_sing2", "best_flat")
# (V, grid): the unrolled K3'/K1 route and the tiled K7' + K6' / K5' + K4'
POOLS = {"unrolled": (3, [0.0, 0.25, 0.5]), "tiled": (16, [0.0, 0.5])}


def _skewed_obs(seed, V, n_cells=16, NS=300):
    """Observations with skewed coverage (every other cell 10-30 SNPs, the
    rest 150-250), so that ``_blocks``' coverage sort engages on blocks of
    8; 1-4 UMIs a slot and one PCR-hot slot of 13-20 UMIs a deep cell
    (wire-v2 deep lanes); genotypes for V samples."""
    rng = np.random.default_rng(seed)
    obs = []
    for c in range(n_cells):
        lo, hi = (10, 31) if c % 2 else (150, 251)
        snps = np.sort(rng.choice(NS, size=int(rng.integers(lo, hi)),
                                  replace=False))
        for j, s in enumerate(snps):
            depth = 1 + (rng.random() < 0.3) * int(rng.integers(1, 4))
            if j == 40:
                depth += int(rng.integers(12, 20))
            for _ in range(depth):
                obs.append((c, s, int(rng.random() < 0.5),
                            int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    gps = rng.dirichlet(np.ones(3), size=(NS, V))
    return (V, NS, n_cells, obs), gps


def _csr(spec, cls=CsrPileup):
    """A fresh pileup of ``_skewed_obs``'s observations (each engine gets
    its own: the wire config cache rides on the pileup)."""
    V, NS, n_cells, obs = spec
    z = np.zeros(n_cells)
    return cls.from_arrays(
        [f"S{i}" for i in range(V)], NS, ["B%04d" % i for i in range(n_cells)],
        z, z, z, obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8))


def _fields(res):
    return (res.llks, res.llk0s, res.llk_ab, res.llk_00)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


def _no_step(*args, **kw):
    raise AssertionError("a spooled block was recomputed")


def _canon_best_flat(best, V, A, sym_a):
    """best_flat with (j, k) sorted on the alpha == 0.5 plane, whose two
    mirrored channels are one value."""
    j, k, a = best // (V * A), (best // A) % V, best % A
    swap = (a == sym_a) & (j > k)
    j, k = np.where(swap, k, j), np.where(swap, j, k)
    return (j * V + k) * A + a


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX engine's run() (the XLA f64 path on the CPU) on each pool's
    pileup, computed once for the module."""
    from demuxlet_tpu.host.csr import CsrPileup as JCsr
    from demuxlet_tpu.models import engine as JE

    out = {}
    for name, (V, grid) in POOLS.items():
        spec, gps = _skewed_obs(3, V)
        out[name] = (spec, gps, JE.DemuxEngine(gps, grid, cell_block=8).run(
            _csr(spec, JCsr)))
    return out


@pytest.mark.parametrize("pool", list(POOLS))
def test_exact_run_matches_jax(jax_runs, pool):
    """Exact run() (K2' + K3', or K2' + K7' + K6' at V=16, plain versions)
    against the JAX engine's f64 run(): every LLK within 1e-9 absolute, on
    coverage-sorted blocks of 8 cells."""
    spec, gps, want = jax_runs[pool]
    V, grid = POOLS[pool]
    csr = _csr(spec)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    assert eng._blocks(csr.nbcs, csr)[1] is not None  # the sort engaged
    got = eng.run(csr)
    kernels = "K2' + K3'" if pool == "unrolled" else "K2' + K7' + K6'"
    assert eng.route.startswith(f"kernels {kernels} (")
    for g, w in zip(_fields(got), _fields(want)):
        assert g.shape == w.shape and g.dtype == np.float64
        assert np.abs(g - w).max() < EXACT_TOL
    assert eng.d2h_bytes == sum(x.nbytes for x in _fields(got))
    assert set(eng.phase_s) == {
        "setup", "setup.nsnp", "setup.wire_cfg", "setup.tables", "prep",
        "prep_wait", "dispatch", "dispatch.front", "dispatch.pair",
        "fetch"}
    assert 0.0 < eng.phase_s["dispatch.pair"] < eng.phase_s["dispatch"]
    assert eng.h2d_bytes > 0


@pytest.mark.parametrize("pool", list(POOLS))
def test_fast_run_matches_jax(jax_runs, pool):
    """Fast run() (K1, or K5' + K4' at V=16, plain versions) against the
    same JAX f64 run(): within 2e-5 relative, the fast contract."""
    spec, gps, want = jax_runs[pool]
    V, grid = POOLS[pool]
    eng = TE.DemuxEngine(gps, grid, cell_block=8, mode="fast", device=CPU)
    got = eng.run(_csr(spec))
    assert eng.route.startswith(
        "kernels K1 (" if pool == "unrolled" else "kernels K5' + K4' (")
    for g, w in zip(_fields(got), _fields(want)):
        assert _rel(g, w) < FAST_TOL


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_compact_from_result_matches_run_compact(mode):
    """compact_from_result of run()'s tensors against run_compact on the
    same engine: llks and llk0s bit-equal, integer fields equal
    (best_flat modulo the alpha == 0.5 swap), floats within 1e-12."""
    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(4, V)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode, device=CPU)
    res = eng.run(_csr(spec))
    llks, llk0s, comp = eng.run_compact(_csr(spec), 0.5)
    np.testing.assert_array_equal(res.llks, llks)
    np.testing.assert_array_equal(res.llk0s, llk0s)
    got = TD.compact_from_result(res.llk_ab, res.llk_00, grid, 0.5)
    for f in dataclasses.fields(comp):
        g, w = getattr(got, f.name), getattr(comp, f.name)
        assert g.dtype == w.dtype and g.shape == w.shape, f.name
        if f.name == "best_flat":
            np.testing.assert_array_equal(_canon_best_flat(g, V, 3, 2),
                                          _canon_best_flat(w, V, 3, 2))
        elif f.name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert _rel(g, w) < 1e-12, f.name


@pytest.mark.parametrize("option", ["xla", "cap127", "f32"])
def test_dense_route_matches_jax(option):
    """The dense route (build_slots, _pad_block, ops/likelihood.py) against
    the JAX engine's run() with the same options: --exact-kernel xla and
    cap_bq=127 in f64 within 1e-12, f32 against the JAX engine's
    dtype=float32 within 1e-5 relative."""
    import jax.numpy as jnp

    from demuxlet_tpu.host.csr import CsrPileup as JCsr
    from demuxlet_tpu.models import engine as JE

    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(5, V)
    kw_t, kw_j = {"exact_kernel": "xla"}, {"exact_kernel": "xla"}
    if option == "cap127":
        kw_t = kw_j = {"cap_bq": 127}
    elif option == "f32":
        kw_t, kw_j = {"dtype": torch.float32}, {"dtype": jnp.float32}
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU, **kw_t)
    got = eng.run(_csr(spec))
    assert eng.route.startswith("dense (")
    want = JE.DemuxEngine(gps, grid, cell_block=8, **kw_j).run(
        _csr(spec, JCsr))
    for g, w in zip(_fields(got), _fields(want)):
        assert np.isfinite(g).all()
        if option == "f32":
            assert _rel(g, w) < 1e-5
        else:
            assert np.abs(g - w).max() < 1e-12
    with pytest.raises(TE.DemuxError, match="dense route"):
        eng.run_compact(_csr(spec), 0.5)


def test_spool_second_run_loads_every_block(tmp_path, monkeypatch):
    """A spooled run writes one file a block; a second run loads every
    block (no block step runs) and its arrays are bit-equal."""
    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(6, V)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    first = eng.run(_csr(spec), spool_dir=str(tmp_path))
    blocks, _ = eng._blocks(16, _csr(spec))
    assert sorted(os.listdir(tmp_path)) == sorted(
        "block_%08d_%d.npz" % (b[0], len(b)) for b in blocks)

    monkeypatch.setattr(eng, "_dispatch", _no_step)
    again = eng.run(_csr(spec), spool_dir=str(tmp_path))
    for a, b in zip(_fields(first), _fields(again)):
        np.testing.assert_array_equal(a, b)
    assert eng.h2d_bytes == 0 and eng.d2h_bytes == 0


def test_spool_file_of_other_cells_is_recomputed(tmp_path, monkeypatch):
    """A block file whose stored cells differ from the block's (another
    blocking) is recomputed, never misattributed."""
    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(6, V)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    first = eng.run(_csr(spec), spool_dir=str(tmp_path))
    blocks, _ = eng._blocks(16, _csr(spec))
    path = tmp_path / ("block_%08d_%d.npz" % (blocks[0][0], len(blocks[0])))
    with np.load(path) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["cells"] = arrs["cells"][::-1].copy()
    arrs["c"] = np.zeros_like(arrs["c"])  # would show if it were loaded
    np.savez(path, **arrs)
    steps = []
    step = eng._dispatch
    monkeypatch.setattr(eng, "_dispatch",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    again = eng.run(_csr(spec), spool_dir=str(tmp_path))
    assert len(steps) == 1
    for a, b in zip(_fields(first), _fields(again)):
        np.testing.assert_array_equal(a, b)
    with np.load(path) as z:  # rewritten with the block's own cells
        np.testing.assert_array_equal(z["cells"], blocks[0])


def test_spool_directory_of_the_jax_engine_resumes(tmp_path, monkeypatch):
    """A spool directory the JAX engine wrote is loaded as it is: no block
    step runs and the arrays equal the JAX run's."""
    from demuxlet_tpu.host.csr import CsrPileup as JCsr
    from demuxlet_tpu.models import engine as JE

    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(7, V)
    want = JE.DemuxEngine(gps, grid, cell_block=8).run(
        _csr(spec, JCsr), spool_dir=str(tmp_path))
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=CPU)
    monkeypatch.setattr(eng, "_dispatch", _no_step)
    got = eng.run(_csr(spec), spool_dir=str(tmp_path))
    for g, w in zip(_fields(got), _fields(want)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def cli_case(tmp_path_factory):
    """A V=4 BAM/VCF (20 cells, 60 SNPs) and the CLI's base arguments on
    the CPU; the parity run with --write-pair."""
    from fixtures import random_workload, write_bam, write_vcf

    from demuxlet_tpu_torch import cli

    tmp = tmp_path_factory.mktemp("run_cli")
    contigs, names, variants, reads, _ = random_workload(
        random.Random(11), n_cells=20, n_snps=60, n_samples=4,
        reads_per_cell=60)
    vcf = write_vcf(str(tmp / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp / "w.bam"), contigs, reads)
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu",
            "--mesh", "none"]
    assert cli.main(base + ["--out", str(tmp / "parity"), "--mode",
                            "parity", "--write-pair"]) == 0
    return tmp, base, _outputs(tmp / "parity")


def _outputs(prefix):
    return {ext: open(f"{prefix}{ext}").read().splitlines()
            for ext in (".single", ".sing2", ".best", ".pair")
            if os.path.exists(f"{prefix}{ext}")}


def _run(main, base, prefix, extra):
    assert main(base + ["--out", str(prefix)] + extra) == 0
    return _outputs(prefix)


def _calls(best):
    from parity_utils import canonicalize_best_line

    return [canonicalize_best_line(l).split("\t")[5] for l in best[1:]]


def test_cli_write_pair_exact_equals_parity(cli_case):
    """--write-pair in exact mode (run() on the kernel route): .pair,
    .single and .sing2 byte-identical to --mode parity --write-pair, .best
    equal after canonicalize_best."""
    from parity_utils import canonicalize_best

    from demuxlet_tpu_torch import cli

    tmp, base, parity = cli_case
    got = _run(cli.main, base, tmp / "wp", ["--write-pair"])
    assert len(got[".pair"]) == len(parity[".pair"]) > 20
    for ext in (".pair", ".single", ".sing2"):
        assert got[ext] == parity[ext], ext
    assert canonicalize_best(got[".best"]) == canonicalize_best(
        parity[".best"])


def test_cli_write_pair_fast_best_calls(cli_case):
    """--write-pair --mode fast: the .best calls equal parity's."""
    from demuxlet_tpu_torch import cli

    tmp, base, parity = cli_case
    got = _run(cli.main, base, tmp / "wpf", ["--write-pair", "--mode",
                                             "fast"])
    assert len(got[".pair"]) == len(parity[".pair"])
    assert _calls(got[".best"]) == _calls(parity[".best"])
    assert len(_calls(got[".best"])) == 20


def test_cli_spool_twice_identical(cli_case):
    """--spool twice: the second run resumes from the block files and
    writes identical outputs."""
    from demuxlet_tpu_torch import cli

    tmp, base, parity = cli_case
    extra = ["--spool", str(tmp / "spool"), "--cell-block", "8"]
    first = _run(cli.main, base, tmp / "sp1", extra)
    assert len(os.listdir(tmp / "spool")) == 3
    assert _run(cli.main, base, tmp / "sp2", extra) == first
    assert first[".single"] == parity[".single"]


@pytest.mark.parametrize("shard", [0, 1])
def test_cli_genome_shard_matches_jax_cli(cli_case, shard):
    """--shard-by genome --num-shards 2 without a coordinator (partial
    LLKs over this shard's SNPs) against the JAX CLI with the same
    options: .single/.sing2 byte-identical, .best after canonicalize_best;
    the shard holds fewer SNPs than the whole run."""
    from parity_utils import canonicalize_best

    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli

    tmp, base, parity = cli_case
    extra = ["--shard-by", "genome", "--num-shards", "2", "--shard-id",
             str(shard)]
    got = _run(cli.main, base, tmp / f"g{shard}", extra)
    want = _run(jcli.main, base, tmp / f"jg{shard}", extra)
    for ext in (".single", ".sing2"):
        assert got[ext] == want[ext], ext
    assert canonicalize_best(got[".best"]) == canonicalize_best(want[".best"])
    n_snp = [int(l.split("\t")[4]) for l in got[".best"][1:]]
    assert sum(n_snp) < sum(int(l.split("\t")[4])
                            for l in parity[".best"][1:])


@pytest.mark.parametrize("extra", [["--cap-BQ", "127"],
                                   ["--exact-kernel", "xla"]],
                         ids=["cap127", "xla"])
def test_cli_dense_route_matches_jax_cli(cli_case, extra):
    """Exact --cap-BQ 127 and --exact-kernel xla (the dense route) against
    the JAX CLI with the same options: .single/.sing2 byte-identical,
    .best after canonicalize_best."""
    from parity_utils import canonicalize_best

    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli

    tmp, base, _ = cli_case
    name = extra[0].strip("-")
    got = _run(cli.main, base, tmp / name, extra)
    want = _run(jcli.main, base, tmp / ("j" + name), extra)
    for ext in (".single", ".sing2"):
        assert got[ext] == want[ext], ext
    assert canonicalize_best(got[".best"]) == canonicalize_best(want[".best"])


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_cli_precision_f32_matches_jax_cli(cli_case, mode):
    """--precision f32 against the JAX CLI run in a subprocess (without
    x64, as a user runs it): equal .best calls, and every numeric column
    of .best, .single and .sing2 within 2e-5 relative."""
    from parity_utils import canonicalize_best_line

    from demuxlet_tpu_torch import cli

    tmp, base, _ = cli_case
    extra = ["--precision", "f32", "--mode", mode]
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "demuxlet_tpu.cli"] + base + extra
        + ["--out", str(tmp / f"jf32{mode}")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = _outputs(tmp / f"jf32{mode}")
    got = _run(cli.main, base, tmp / f"f32{mode}", extra)
    assert _calls(got[".best"]) == _calls(want[".best"])
    for ext in (".best", ".single", ".sing2"):
        assert len(got[ext]) == len(want[ext]) > 1
        for lg, lw in zip(got[ext][1:], want[ext][1:]):
            for x, y in zip(canonicalize_best_line(lg).split("\t"),
                            canonicalize_best_line(lw).split("\t")):
                try:
                    fx, fy = float(x), float(y)
                except ValueError:
                    assert x == y
                    continue
                assert abs(fx - fy) <= FAST_TOL * max(1.0, abs(fy)), (x, y)


def test_cli_profile_writes_a_trace(cli_case):
    """--profile DIR writes a torch.profiler Chrome trace into DIR, which
    holds the program's spans from the engine's pass to the writes, the
    prep spans on the prefetch threads."""
    import json

    from demuxlet_tpu_torch import cli

    tmp, base, parity = cli_case
    got = _run(cli.main, base, tmp / "prof", ["--profile",
                                              str(tmp / "trace")])
    files = os.listdir(tmp / "trace")
    assert files == ["torch_trace.json"]
    with open(tmp / "trace" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert events
    # the engine's pass, cell_stats and the writes, the prefetch threads'
    # prep spans too
    tids = {}
    for e in events:
        tids.setdefault(e.get("name"), set()).add(e.get("tid"))
    for name in ("setup", "dispatch", "fetch", "cell_stats",
                 "render.single", "render.pass2"):
        assert "demux." + name in tids, name
    assert tids["demux.prep"] - tids["demux.setup"]
    assert got[".single"] == parity[".single"]


# ---------------------------------------------------------------- card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _launch_modules(mode, V, A):
    """The kernel modules of a mode's route and of the other route."""
    from demuxlet_tpu_torch.kernels import (
        extras_exact,
        extras_fast,
        front_exact,
        pair_exact,
        pair_fast,
        pair_tiled_exact,
        pair_tiled_fast,
    )

    every = [front_exact, pair_exact, pair_tiled_exact, extras_exact,
             pair_fast, pair_tiled_fast, extras_fast]
    small = V * V * A <= 384
    if mode == "exact":
        path = [front_exact] + ([pair_exact] if small
                                else [pair_tiled_exact, extras_exact])
    else:
        path = [pair_fast] if small else [pair_tiled_fast, extras_fast]
    return path, [k for k in every if k not in path]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_run_matches_run_compact_on_card(cuda_device, mode, pool):
    """run() on the card launches its route's kernels once per block and
    the other route's never; llks and llk0s bit-equal to run_compact's;
    compact_from_result of its tensors equal to run_compact's rows
    (integers; floats within 1e-9 absolute in exact mode, 2e-5 relative
    in fast mode)."""
    V, grid = POOLS[pool]
    spec, gps = _skewed_obs(8, V, n_cells=40)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode,
                         device=cuda_device)
    path, absent = _launch_modules(mode, V, len(grid))
    for k in path + absent:
        k.reset_launches()
    res = eng.run(_csr(spec))
    n_blocks = len(eng._blocks(40, _csr(spec))[0])
    assert [k.launches for k in path] == [n_blocks] * len(path)
    assert not any(k.launches for k in absent)
    llks, llk0s, comp = eng.run_compact(_csr(spec), 0.5)
    np.testing.assert_array_equal(res.llks, llks)
    np.testing.assert_array_equal(res.llk0s, llk0s)
    got = TD.compact_from_result(res.llk_ab, res.llk_00, grid, 0.5)
    sym = grid.index(0.5)
    for f in dataclasses.fields(comp):
        g, w = getattr(got, f.name), getattr(comp, f.name)
        if f.name == "best_flat":
            np.testing.assert_array_equal(
                _canon_best_flat(g, V, len(grid), sym),
                _canon_best_flat(w, V, len(grid), sym))
        elif f.name in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        elif mode == "exact":
            assert np.abs(g - w).max() < EXACT_TOL, f.name
        else:
            assert _rel(g, w) < FAST_TOL, f.name


@pytest.mark.cuda
def test_spool_second_run_launches_no_kernel_on_card(cuda_device, tmp_path):
    """A spooled second run on the card launches no kernel and gives
    bit-equal arrays."""
    V, grid = POOLS["unrolled"]
    spec, gps = _skewed_obs(9, V, n_cells=40)
    eng = TE.DemuxEngine(gps, grid, cell_block=8, device=cuda_device)
    first = eng.run(_csr(spec), spool_dir=str(tmp_path))
    path, absent = _launch_modules("exact", V, len(grid))
    for k in path + absent:
        k.reset_launches()
    again = eng.run(_csr(spec), spool_dir=str(tmp_path))
    assert not any(k.launches for k in path + absent)
    for a, b in zip(_fields(first), _fields(again)):
        np.testing.assert_array_equal(a, b)
