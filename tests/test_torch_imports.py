"""The port stands without JAX and refuses what it does not cover yet."""

import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from demuxlet_tpu.utils.logging_utils import DemuxError

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


def test_every_port_module_imports_without_jax():
    mods = _port_modules()
    assert "demuxlet_tpu_torch.kernels.pair_fast" in mods
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "assert 'jax' not in [k for k, v in sys.modules.items() if v]\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_no_jax_import_in_port_sources():
    pat = re.compile(r"^\s*(import jax|from jax)", re.M)
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
    # V*V*A = 8*8*7 > 384: the tiled exact kernels (K6/K7)
    (["--field", "GT", "--alpha", "0"]
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
    with pytest.raises(DemuxError, match=item):
        cli.main(["--sam", str(tmp_path / "none.bam"), "--vcf",
                  str(tmp_path / "none.vcf"), "--out", str(tmp_path / "o"),
                  "--device", "cpu"] + extra)
