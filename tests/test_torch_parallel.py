"""The port's device mesh (``demuxlet_tpu_torch/parallel/mesh.py``) on the
CPU: the slot-axis step against the JAX sharded step on the 8 virtual CPU
devices of tests/conftest.py, ``make_mesh`` and ``pad_to_mesh`` against
JAX's, the engine under a mesh of CPU members against the engine on one
device (its host tables built once per wire config and placed on every
member), and the CLI's ``--mesh`` against ``--mesh none`` and the JAX
CLI's ``--mesh 2x2``."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu_torch.models import decision as TD
from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops import likelihood as TL
from demuxlet_tpu_torch.parallel import mesh as tmesh
from test_parallel import _block
from test_torch_run import _csr, _skewed_obs

torch.set_num_threads(2)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (V, grid): the unrolled K3'/K1 route and the tiled K7' + K6' / K5' + K4'
POOLS = {"unrolled": (4, [0.0, 0.25, 0.5]), "tiled": (16, [0.0, 0.5])}


def _cpu_mesh(n_b, n_s):
    return tmesh.make_mesh(n_b, n_s, devices=[CPU] * (n_b * n_s))


@pytest.mark.parametrize("n_b,n_s", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_sharded_step_matches_jax(n_b, n_s):
    """The slot-axis step on each row of an n_b x n_s CPU mesh (row r
    takes the r-th of n_b equal cell slices, the JAX step's "b" layout)
    against the JAX sharded step on the virtual devices, on the shapes of
    tests/test_parallel.py: the port's split against its own unsplit
    block_llks exactly at n_s = 1 and within 1e-9 otherwise (its partial
    sums reassociate the slot sum), as the JAX test holds its step against
    its single device; against JAX within 1e-9 (the packages' count
    contractions sum in another order: ~1e-13 here)."""
    from demuxlet_tpu.parallel import mesh as pmesh

    B, S, V, A = 16, 32, 4, 3
    cnt, msk, gps, gp0, logf, w = _block(B, S, V, A)
    jmesh = pmesh.make_mesh(n_b=n_b, n_s=n_s)
    sc, sm, sg, s0 = pmesh.shard_block(
        jmesh, jnp.asarray(cnt), jnp.asarray(msk), jnp.asarray(gps),
        jnp.asarray(gp0))
    lf, ww = pmesh.replicate(jmesh, jnp.asarray(logf), jnp.asarray(w))
    want = [np.asarray(x) for x in pmesh.build_sharded_step(
        jmesh, n_alpha=A)(sc, sm, sg, s0, lf, ww)]

    # per-slot genotype rows as a table taken by idx = slot number
    idx = np.arange(B * S, dtype=np.int64).reshape(B, S)
    tables = tuple(torch.from_numpy(x) for x in (
        gps.reshape(B * S, V, 3), gp0.reshape(B * S, 3), logf, w))
    unsplit = [x.numpy() for x in TL.block_llks(
        *(torch.from_numpy(x) for x in (idx, msk, cnt)), *tables, A)]
    mesh = _cpu_mesh(n_b, n_s)
    step = tmesh.build_sharded_step(mesh, A)
    per = B // n_b
    rows = []
    for r in range(n_b):
        sl = slice(r * per, (r + 1) * per)
        parts = [tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in p)
                 for p in tmesh.split_slots(n_s, idx[sl], msk[sl], cnt[sl])]
        rows.append(step(r, parts, [tables] * n_s))
    got = [torch.cat(f).numpy() for f in zip(*rows)]
    tol = 0 if n_s == 1 else 1e-9
    for g, u, j in zip(got, unsplit, want):
        assert g.shape == j.shape
        np.testing.assert_allclose(g, u, atol=tol, rtol=0)
        np.testing.assert_allclose(g, j, atol=1e-9, rtol=0)


@pytest.mark.parametrize("kw", [
    dict(n_b=3, n_s=4),  # more devices than there are
    dict(n_b=1, n_s=0),  # no slot axis
    dict(n_b=2, n_s=2),
    dict(n_b=None, n_s=2),  # n_b defaults to 8 // 2
])
def test_make_mesh_as_jax(kw):
    """make_mesh over 8 devices raises where the JAX make_mesh raises,
    with its message, and otherwise gives the same grid shape, row-major
    over the devices."""
    from demuxlet_tpu.parallel import mesh as pmesh

    devs = [torch.device("cpu", i) for i in range(8)]
    try:
        want = dict(pmesh.make_mesh(**kw).shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(devices=devs, **kw)
        assert str(got.value) == str(e)
        return
    mesh = tmesh.make_mesh(devices=devs, **kw)
    assert mesh.shape == want
    assert [d for row in mesh.devices for d in row] == \
        devs[: want["b"] * want["s"]]


def test_make_mesh_refuses_an_empty_mesh():
    """Where n_b defaults to 0 (8 // 16) the JAX mesh is empty; the port's
    refuses it: it could run no block."""
    with pytest.raises(ValueError, match="has no device"):
        tmesh.make_mesh(None, 16, devices=[CPU] * 8)


def test_pad_to_mesh_as_jax():
    from demuxlet_tpu.parallel import mesh as pmesh

    assert tmesh.pad_to_mesh(10, 4) == 12
    assert tmesh.pad_to_mesh(16, 4) == 16
    assert tmesh.pad_to_mesh(1, 8, block=8) == 64
    for n in range(0, 70, 7):
        for shard in (1, 2, 3, 8):
            for block in (1, 4, 32):
                assert tmesh.pad_to_mesh(n, shard, block) == \
                    pmesh.pad_to_mesh(n, shard, block)


def test_split_slots_refuses_ragged_parts():
    x = np.zeros((2, 6))
    assert [p[0].shape for p in tmesh.split_slots(3, x)] == [(2, 2)] * 3
    with pytest.raises(ValueError, match="do not split"):
        tmesh.split_slots(4, x)


@pytest.fixture(scope="module")
def pools():
    """Per pool: a 32-cell skewed pileup spec and its genotypes."""
    return {name: _skewed_obs(5, V, n_cells=32)
            for name, (V, _) in POOLS.items()}


def _compact_fields(llks, llk0s, comp):
    return [llks, llk0s] + [getattr(comp, f)
                            for f in TD.CompactResult.__dataclass_fields__]


@pytest.mark.parametrize("mode", ["exact", "fast"])
@pytest.mark.parametrize("pool", list(POOLS))
def test_engine_mesh_bit_equal(pools, pool, mode):
    """run_compact and run() on (2, 1) and (4, 1) CPU meshes equal the
    engine on one device bit for bit (whole blocks per row; 4 blocks of
    8 cells, coverage-sorted), on the unrolled and the tiled pool; the
    route names the mesh."""
    spec, gps = pools[pool]
    V, grid = POOLS[pool]
    one = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode, device=CPU)
    want_c = _compact_fields(*one.run_compact(_csr(spec), 0.5))
    csr = _csr(spec)
    want_r = one.run(csr)
    assert len(one._blocks(csr.nbcs, csr)[0]) == 4
    for n_b in (2, 4):
        eng = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode,
                             mesh=_cpu_mesh(n_b, 1))
        got_c = _compact_fields(*eng.run_compact(_csr(spec), 0.5))
        assert eng.route == one.route + f" on a {n_b}x1 mesh"
        for g, w in zip(got_c, want_c):
            assert np.array_equal(g, w)
        got_r = eng.run(_csr(spec))
        for f in ("llks", "llk0s", "llk_ab", "llk_00"):
            assert np.array_equal(getattr(got_r, f), getattr(want_r, f)), f
        # one table set a member: each row's own
        assert sorted(eng._dev) == [(mode, (r, 0)) for r in range(n_b)]


def test_engine_slot_axis_takes_the_dense_route(pools):
    """Exact run() on a (2, 2) CPU mesh takes the dense route, split on
    the slot axis: within 1e-9 of the kernel route's run() on one device
    and of the dense route's (--exact-kernel xla) on one device. Fast mode
    refuses a slot axis."""
    spec, gps = pools["unrolled"]
    V, grid = POOLS["unrolled"]
    eng = TE.DemuxEngine(gps, grid, cell_block=8, mesh=_cpu_mesh(2, 2))
    assert eng.dense_reason == "--mesh 2x2 slot axis"
    got = eng.run(_csr(spec))
    assert eng.route == (f"dense ({torch.float64}; --mesh 2x2 slot axis) "
                         "on a 2x2 mesh")
    for ref in (TE.DemuxEngine(gps, grid, cell_block=8, device=CPU),
                TE.DemuxEngine(gps, grid, cell_block=8, device=CPU,
                               exact_kernel="xla")):
        want = ref.run(_csr(spec))
        for f in ("llks", "llk0s", "llk_ab", "llk_00"):
            err = np.abs(getattr(got, f) - getattr(want, f)).max()
            assert err <= 1e-9, (ref.route, f, err)
    with pytest.raises(Exception, match="requires --mode exact"):
        TE.DemuxEngine(gps, grid, mode="fast", mesh=_cpu_mesh(1, 2))


@pytest.fixture(scope="module")
def cli_base(tmp_path_factory):
    """A 20-cell BAM/VCF (3 samples, 40 SNPs): the CLI arguments, --device
    cpu and blocks of 8 cells (3 blocks)."""
    import random

    from fixtures import random_workload, write_bam, write_vcf

    tmp = tmp_path_factory.mktemp("mesh_cli")
    contigs, names, variants, reads, _ = random_workload(
        random.Random(29), n_cells=20, n_snps=40, n_samples=3,
        reads_per_cell=50)
    vcf = write_vcf(str(tmp / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp / "w.bam"), contigs, reads)
    return tmp, ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device",
                 "cpu", "--cell-block", "8"]


def _read(out):
    return {ext: open(out + ext).read().splitlines()
            for ext in (".single", ".sing2", ".best")}


def _port_cli(tmp, base, name, extra):
    from demuxlet_tpu_torch import cli

    out = str(tmp / name)
    assert cli.main(base + ["--out", out] + extra) == 0
    return _read(out)


@pytest.mark.parametrize("mode,mesh", [("exact", "2x1"), ("fast", "2x1"),
                                       ("exact", "2x2")])
def test_cli_mesh_matches_no_mesh(cli_base, mode, mesh):
    """--mesh 2x1 in both modes is byte-identical to --mesh none;
    --mesh 2x2 (exact: the dense route split on the slot axis) gives
    byte-identical .single and .sing2, and the same .best after
    canonicalize_best: the mirrored alpha == 0.5 pairs are exact ties,
    which the dense route's sums order by their last bits (the exact-mode
    contract)."""
    from parity_utils import canonicalize_best

    tmp, base = cli_base
    base = base + ["--mode", mode]
    one = _port_cli(tmp, base, f"{mode}_none", ["--mesh", "none"])
    got = _port_cli(tmp, base, f"{mode}_{mesh}", ["--mesh", mesh])
    assert len(got[".best"]) == 21
    assert got[".single"] == one[".single"]
    assert got[".sing2"] == one[".sing2"]
    if mesh == "2x1":
        assert got[".best"] == one[".best"]
    else:
        assert canonicalize_best(got[".best"]) == canonicalize_best(
            one[".best"])


def test_cli_mesh_2x2_matches_jax_cli(cli_base):
    """The port's --mesh 2x2 (exact) against the JAX CLI's --mesh 2x2 on 4
    virtual CPU devices, run in a subprocess: .single and .sing2
    byte-identical, .best after canonicalize_best."""
    from parity_utils import canonicalize_best

    tmp, base = cli_base
    got = _port_cli(tmp, base, "port_2x2", ["--mesh", "2x2"])
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_ENABLE_X64="true",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = str(tmp / "jax_2x2")
    proc = subprocess.run(
        [sys.executable, "-m", "demuxlet_tpu.cli"] + base
        + ["--out", out, "--mesh", "2x2"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Device mesh: 2 (barcodes) x 2 (slots)" in proc.stderr
    want = _read(out)
    assert got[".single"] == want[".single"]
    assert got[".sing2"] == want[".sing2"]
    assert canonicalize_best(got[".best"]) == canonicalize_best(want[".best"])


def _tables_of(eng):
    """Every table set the engine placed: {(kind, member): tensors}."""
    return {key: tab if isinstance(tab, tuple) else
            tuple(getattr(tab, f) for f in tab.__dataclass_fields__)
            for key, tab in eng._dev.items()}


def _same_tables(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("mode,pool,n_b,n_s", [
    ("exact", "unrolled", 2, 1), ("fast", "unrolled", 2, 1),
    ("exact", "tiled", 2, 1), ("fast", "tiled", 2, 1),
    ("exact", "unrolled", 2, 2)])
def test_mesh_builds_host_tables_once(pools, mode, pool, n_b, n_s):
    """On 2x1 and 2x2 CPU meshes, run_compact and run() build each kind
    of host table once per wire config (``host_table_builds``), and every
    member's tables equal one device's bit for bit: the kernel route's
    on each row's first member, the dense route's (2x2, the slot axis)
    on every member."""
    spec, gps = pools[pool]
    V, grid = POOLS[pool]
    dense = n_s > 1
    one = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode, device=CPU,
                         exact_kernel="xla" if dense else "auto")
    eng = TE.DemuxEngine(gps, grid, cell_block=8, mode=mode,
                         mesh=_cpu_mesh(n_b, n_s))
    for e in (one, eng):
        if not dense:
            e.run_compact(_csr(spec), 0.5)
        e.run(_csr(spec))
    cfg = eng._cfg
    kind = "dense" if dense else mode
    assert eng.host_table_builds == {(kind, None if dense else cfg): 1}
    assert one.host_table_builds == eng.host_table_builds
    want = _tables_of(one)[kind, (0, 0)]
    placed = _tables_of(eng)
    members = [(r, s) for r in range(n_b) for s in range(n_s if dense
                                                          else 1)]
    assert sorted(placed) == [(kind, m) for m in members]
    for m in members:
        _same_tables(placed[kind, m], want)
