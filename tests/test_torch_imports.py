"""The port stands without JAX, runs large pools in every mode and
refuses what the JAX CLI refuses."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from demuxlet_tpu_torch.utils.logging_utils import DemuxError

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "demuxlet_tpu_torch")


def _port_modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").replace(".__init__", ""))
    return sorted(mods)


# the port stands alone: it imports none of these
BLOCKED = ("jax", "demuxlet_tpu", "oracle")
_BLOCK = "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n"
                                  for m in BLOCKED)
_NONE_LOADED = ("assert not [k for k, v in sys.modules.items() if v and "
                f"k.split('.')[0] in {BLOCKED!r}]\n")


def test_every_port_module_imports_without_jax():
    """With jax, demuxlet_tpu and oracle blocked, every port module
    imports."""
    mods = _port_modules()
    assert "demuxlet_tpu_torch.kernels.pair_fast" in mods
    assert "demuxlet_tpu_torch.native.ingest" in mods
    code = (
        _BLOCK + "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n" + _NONE_LOADED + "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_cli_runs_without_jax_package(tmp_path):
    """With jax, demuxlet_tpu and oracle blocked, the port CLI runs on the
    CPU in parity, exact (the default) and fast modes on one BAM/VCF, with
    --write-pair, --spool and --exact-kernel xla (the full-tensor run()),
    on a 2x1 mesh (parallel/mesh.py), and in fast mode on a large pool
    (V=8, 7 alphas: K5' + K4'); the exact .single equals parity's, and so
    do those of run() and of the mesh."""
    import random

    from fixtures import random_workload, write_bam, write_vcf

    contigs, names, variants, reads, _ = random_workload(
        random.Random(11), n_cells=12, n_snps=40, n_samples=3,
        reads_per_cell=40)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu",
            "--mesh", "none"]
    large = tmp_path / "large"
    large.mkdir()
    runs = [("parity", base + ["--mode", "parity"]), ("exact", base),
            ("fast", base + ["--mode", "fast"]),
            ("write_pair", base + ["--write-pair"]),
            ("spool", base + ["--spool", str(tmp_path / "spool")]),
            ("xla", base + ["--exact-kernel", "xla"]),
            ("mesh", base[:-2] + ["--mesh", "2x1"]),
            ("fast_large", _large_pool_case(large, 3) + ["--mode", "fast"])]
    code = (
        _BLOCK + "from demuxlet_tpu_torch import cli\n"
        f"for name, argv in {runs!r}:\n"
        f"    out = {str(tmp_path)!r} + '/' + name\n"
        "    assert cli.main(argv + ['--out', out]) == 0\n"
        + _NONE_LOADED + "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    for name, _ in runs:
        n = 11 if name == "fast_large" else 13
        assert len((tmp_path / f"{name}.best").read_text().splitlines()) == n
    for name in ("exact", "write_pair", "spool", "xla", "mesh"):
        assert (tmp_path / f"{name}.single").read_text() == (
            tmp_path / "parity.single").read_text(), name
    assert (tmp_path / "write_pair.pair").stat().st_size > 0
    assert os.listdir(tmp_path / "spool")


def test_package_import_settles_host_math():
    """Importing the port calls torch.exp once, on one f64 on the importing
    thread (utils/device.settle_host_math), before any threaded math: MKL's
    vector math, first called from several of torch's threads at once, ran
    one thread's share of an exp or log at reduced accuracy in about 3 of
    100 fresh processes."""
    code = (
        "import torch\ncalls = []\nexp = torch.exp\n"
        "def spy(x, *a, **k):\n"
        "    calls.append((x.numel(), str(x.dtype)))\n"
        "    return exp(x, *a, **k)\n"
        "torch.exp = spy\nimport demuxlet_tpu_torch\nprint(calls)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip() == "[(1, 'torch.float64')]"


def test_chip_smoke_fixtures_without_jax_package(tmp_path):
    """chip_smoke.py (which blocks jax, demuxlet_tpu and oracle) writes its
    CLI BAM/VCF through tests/fixtures.py with the port's bgzf bound under
    the JAX package's module name; no module of the blocked packages loads,
    and the port CLI's default mode runs on that input on the CPU."""
    code = (
        "import sys\nimport chip_smoke\n"
        "from demuxlet_tpu_torch import cli\n"
        f"base = chip_smoke.cli_case({str(tmp_path)!r}, 16, 4, 10)\n"
        f"out = {str(tmp_path)!r} + '/t'\n"
        "assert cli.main(base + ['--out', out, '--device', 'cpu']) == 0\n"
        "assert not [k for k, v in sys.modules.items() if v and "
        f"v.__name__.split('.')[0] in {BLOCKED!r}]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    assert len((tmp_path / "t.best").read_text().splitlines()) == 5


def test_no_jax_import_in_port_sources():
    """No source of the port, and not chip_smoke.py, imports jax,
    demuxlet_tpu or oracle."""
    pat = re.compile(r"^\s*(import|from) (jax|demuxlet_tpu|oracle)\b(?!_)",
                     re.M)
    assert pat.search("    from demuxlet_tpu.io import bam")
    assert pat.search("from oracle import numpy_oracle as O")
    assert pat.search("import jax.numpy as jnp")
    assert not pat.search("from demuxlet_tpu_torch.io import bam")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as fh:
            assert not pat.search(fh.read()), p


def test_chip_smoke_fails_without_a_card(tmp_path):
    """No CUDA device: non-zero exit, no ok line. A directory that holds
    chip_smoke.py alone fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (tmp_path, shutil.copy(
                            os.path.join(REPO, "chip_smoke.py"), tmp_path))):
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize("extra,item", [
    # the JAX CLI's refusals of --dist-coordinator and --mesh
    (["--dist-coordinator", "localhost:1", "--num-shards", "1"],
     "requires --num-shards >= 2"),
    (["--mode", "fast", "--mesh", "1x2"], "requires --mode exact"),
    (["--mesh", "2x3"], "power of two"),
    (["--mode", "fast", "--cap-BQ", "127"], "use --mode exact"),
    (["--mode", "fast", "--device", "tpu"], "cpu"),
])
def test_cli_refuses_unported(tmp_path, extra, item):
    from demuxlet_tpu_torch import cli

    with pytest.raises(DemuxError, match=item):
        cli.main(["--sam", str(tmp_path / "none.bam"), "--vcf",
                  str(tmp_path / "none.vcf"), "--out", str(tmp_path / "o"),
                  "--device", "cpu"] + extra)


@pytest.mark.parametrize("extra", [
    ["--exact-kernel", "xla"],  # exact is the default mode
    ["--mode", "exact", "--cap-BQ", "127"],
    ["--mode", "fast", "--write-pair"],
    ["--mode", "fast", "--spool", "spool_dir"],
    ["--mode", "fast", "--profile", "trace_dir"],
    ["--mode", "fast", "--shard-by", "genome", "--num-shards", "2"],
    ["--mode", "fast", "--precision", "f32"],
], ids=["xla", "cap127", "write_pair", "spool", "profile", "genome",
        "f32"])
def test_cli_runs_formerly_refused_option(tmp_path, extra):
    """Each option the port refused before the full-tensor run() runs on
    the CPU and writes its outputs: .single, .sing2 and .best for every
    cell (and .pair, the spool's block files or the trace where asked);
    the .best calls equal --mode parity's where the option keeps the whole
    genome."""
    from demuxlet_tpu_torch import cli

    from parity_utils import canonicalize_best_line

    base = _workload(tmp_path, 5, 8)  # the default grid
    extra = [str(tmp_path / x) if x.endswith("_dir") else x for x in extra]
    calls = {}
    for name, args in (("run", extra), ("parity", ["--mode", "parity"])):
        out = str(tmp_path / name)
        assert cli.main(base + ["--out", out] + args) == 0
        with open(out + ".best") as fh:
            calls[name] = [canonicalize_best_line(l).split("\t")[5]
                           for l in fh.read().splitlines()]
        assert os.path.exists(out + ".single") and os.path.exists(
            out + ".sing2")
    assert len(calls["run"]) == 11
    if "genome" not in extra:
        assert calls["run"] == calls["parity"]
    if "--write-pair" in extra:
        assert os.path.getsize(tmp_path / "run.pair") > 0
    for opt, want in (("--spool", ".npz"), ("--profile", ".json")):
        if opt in extra:
            d = extra[extra.index(opt) + 1]
            assert [f for f in os.listdir(d) if f.endswith(want)]


def _workload(tmp_path, seed, n_samples):
    """A BAM/VCF of 10 cells and 40 SNPs for n_samples samples: the CLI
    arguments, --device cpu."""
    import random

    from fixtures import random_workload, write_bam, write_vcf

    contigs, names, variants, reads, _ = random_workload(
        random.Random(seed), n_cells=10, n_snps=40, n_samples=n_samples,
        reads_per_cell=50)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    return ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu"]


def _large_pool_case(tmp_path, seed):
    """A V=8 BAM/VCF and the 7-point grid (V*V*A = 448 > 384): the CLI
    arguments, --device cpu."""
    grid = (0, 0.1, 0.2, 0.25, 0.3, 0.4, 0.5)
    return _workload(tmp_path, seed, 8) + [
        a for x in grid for a in ("--alpha", str(x))]


def test_cli_fast_runs_large_pool(tmp_path):
    """--mode fast on V=8 and the 7-point grid (V*V*A = 448 > 384) runs on
    the tiled K5' + K4' (their plain versions on the CPU): its .best calls
    (the BEST column) equal --mode parity's after canonicalize_best_line."""
    from parity_utils import canonicalize_best_line

    from demuxlet_tpu_torch import cli

    base = _large_pool_case(tmp_path, 3)
    calls = {}
    for mode in ("fast", "parity"):
        out = str(tmp_path / mode)
        assert cli.main(base + ["--out", out, "--mode", mode]) == 0
        with open(out + ".best") as fh:
            calls[mode] = [canonicalize_best_line(l).split("\t")[5]
                           for l in fh.read().splitlines()[1:]]
    assert len(calls["fast"]) == 10
    assert calls["fast"] == calls["parity"]


def test_cli_exact_runs_large_pool(tmp_path):
    """V*V*A = 8*8*7 > 384 in exact mode (the default) runs on the tiled
    K7' + K6' (their plain versions on the CPU): .single and .sing2 equal
    --mode parity's, .best equal after canonicalize_best."""
    from parity_utils import canonicalize_best

    from demuxlet_tpu_torch import cli

    base = _large_pool_case(tmp_path, 13)
    out = {}
    for name, extra in (("exact", []), ("parity", ["--mode", "parity"])):
        assert cli.main(base + ["--out", str(tmp_path / name)] + extra) == 0
        out[name] = {ext: (tmp_path / (name + ext)).read_text().splitlines()
                     for ext in (".single", ".sing2", ".best")}
    assert len(out["exact"][".best"]) == 11
    for ext in (".single", ".sing2"):
        assert out["exact"][ext] == out["parity"][ext], ext
    assert canonicalize_best(out["exact"][".best"]) == canonicalize_best(
        out["parity"][".best"])
