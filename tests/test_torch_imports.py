"""The port stands without JAX and refuses what it does not cover yet."""

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
    CPU in parity, exact (the default) and fast modes on one BAM/VCF; the
    exact .single equals parity's."""
    import random

    from fixtures import random_workload, write_bam, write_vcf

    contigs, names, variants, reads, _ = random_workload(
        random.Random(11), n_cells=12, n_snps=40, n_samples=3,
        reads_per_cell=40)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    runs = [("parity", ["--mode", "parity"]), ("exact", []),
            ("fast", ["--mode", "fast"])]
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu",
            "--mesh", "none"]
    code = (
        _BLOCK + "from demuxlet_tpu_torch import cli\n"
        f"for name, extra in {runs!r}:\n"
        f"    out = {str(tmp_path)!r} + '/' + name\n"
        f"    assert cli.main({base!r} + ['--out', out] + extra) == 0\n"
        + _NONE_LOADED + "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
    for name, _ in runs:
        assert len((tmp_path / f"{name}.best").read_text().splitlines()) == 13
    assert (tmp_path / "exact.single").read_text() == (
        tmp_path / "parity.single").read_text()


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
    (["--exact-kernel", "xla"], "item 12"),  # exact is the default mode
    (["--mode", "exact", "--cap-BQ", "127"], "item 12"),
    (["--mode", "fast", "--write-pair"], "item 12"),
    (["--mode", "fast", "--spool", "spool_dir"], "item 12"),
    (["--mode", "fast", "--profile", "trace_dir"], "item 12"),
    (["--mode", "fast", "--dist-coordinator", "localhost:1",
      "--num-shards", "2"], "item 15"),
    (["--mode", "fast", "--shard-by", "genome", "--num-shards", "2"],
     "items 12 and 15"),
    (["--mode", "fast", "--mesh", "2x1"], "item 14"),
    (["--mode", "fast", "--precision", "f32"], "item 9"),
    (["--mode", "fast", "--device", "tpu"], "cpu"),
    # V*V*A = 8*8*7 > 384 in fast mode: the tiled f32 kernels (K4/K5)
    (["--mode", "fast", "--field", "GT", "--alpha", "0"]
     + [a for x in (0.1, 0.2, 0.25, 0.3, 0.4, 0.5)
        for a in ("--alpha", str(x))], "item 13"),
])
def test_cli_refuses_unported(tmp_path, extra, item):
    from demuxlet_tpu_torch import cli

    if item == "item 13":  # the pool size is known once the VCF is read
        import random

        from fixtures import random_workload, write_vcf

        contigs, names, variants, _, _ = random_workload(
            random.Random(3), n_cells=2, n_snps=10, n_samples=8)
        write_vcf(str(tmp_path / "none.vcf"), names, variants,
                  contigs=contigs)
        item = "K4/K5.*item 13b"
    with pytest.raises(DemuxError, match=item):
        cli.main(["--sam", str(tmp_path / "none.bam"), "--vcf",
                  str(tmp_path / "none.vcf"), "--out", str(tmp_path / "o"),
                  "--device", "cpu"] + extra)


def test_cli_exact_runs_large_pool(tmp_path):
    """V*V*A = 8*8*7 > 384 in exact mode (the default) runs on the tiled
    K7' + K6' (their plain versions on the CPU): .single and .sing2 equal
    --mode parity's, .best equal after canonicalize_best."""
    import random

    from fixtures import random_workload, write_bam, write_vcf
    from parity_utils import canonicalize_best

    from demuxlet_tpu_torch import cli

    contigs, names, variants, reads, _ = random_workload(
        random.Random(13), n_cells=10, n_snps=40, n_samples=8,
        reads_per_cell=50)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu",
            "--alpha", "0"] + [a for x in (0.1, 0.2, 0.25, 0.3, 0.4, 0.5)
                               for a in ("--alpha", str(x))]
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
