"""The kernel build's cache key (``kernels/build.source_digest``): a built
library is named by the hash of its source, the headers beside it and the
nvcc flags, so an edited header never loads a stale library. Needs no
nvcc."""

import os

import pytest

from demuxlet_tpu_torch.kernels import build as kbuild


@pytest.fixture
def csrc(tmp_path):
    files = {"k.cu": '#include "acc.cuh"\nint k;\n', "acc.cuh": "int a;\n",
             "other.cu": "int o;\n", "notes.txt": "x\n"}
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    return tmp_path


def _edit(path, text="// edited\n"):
    with open(path, "a") as fh:
        fh.write(text)


@pytest.mark.parametrize("edited,changes", [
    ("k.cu", True),
    ("acc.cuh", True),
    ("new.cuh", True),  # a header that did not exist before
    ("other.cu", False),  # another kernel's source
    ("notes.txt", False),
])
def test_digest_follows_what_the_build_reads(csrc, edited, changes):
    before = kbuild.source_digest("k", str(csrc))
    _edit(os.path.join(csrc, edited))
    after = kbuild.source_digest("k", str(csrc))
    assert (before != after) == changes


def test_digest_follows_flags_and_is_stable(csrc):
    a = kbuild.source_digest("k", str(csrc))
    assert a == kbuild.source_digest("k", str(csrc))
    assert a != kbuild.source_digest("k", str(csrc),
                                     (*kbuild.NVCC_FLAGS, "-DSTEP=1"))


def test_repo_kernels_hash_their_headers():
    """Every csrc/*.cu of the port has a digest, and it covers the shared
    header the exact pair kernels include."""
    names = sorted(f[:-3] for f in os.listdir(kbuild.CSRC) if f.endswith(".cu"))
    assert {"pair_exact", "pair_tiled_exact"} <= set(names)
    assert os.path.exists(os.path.join(kbuild.CSRC, "logprod.cuh"))
    for name in names:
        with open(os.path.join(kbuild.CSRC, name + ".cu")) as fh:
            text = fh.read()
        if '#include "logprod.cuh"' in text:
            assert name in ("pair_exact", "pair_tiled_exact")
        assert len(kbuild.source_digest(name)) == 64
