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
    headers the pair kernels, K6' and K4' include."""
    shared = ("pair_exact", "pair_tiled_exact", "pair_fast",
              "pair_tiled_fast", "extras_exact", "extras_fast")
    names = sorted(f[:-3] for f in os.listdir(kbuild.CSRC) if f.endswith(".cu"))
    assert set(shared) <= set(names)
    for header in ("logprod.cuh", "stage.cuh", "tiled.cuh", "extras.cuh"):
        assert os.path.exists(os.path.join(kbuild.CSRC, header))
    for name in names:
        with open(os.path.join(kbuild.CSRC, name + ".cu")) as fh:
            text = fh.read()
        assert ('.cuh"' in text) == (name in shared), name
        assert len(kbuild.source_digest(name)) == 64


def test_concurrent_builds_of_one_library(csrc, tmp_path, monkeypatch):
    """Two threads of one process building the same library (the same
    digest) both return its path; neither finds its temporary file taken
    by the other. nvcc is replaced by a stand-in that returns only when
    both builds have written their -o files."""
    import subprocess
    import threading
    from concurrent.futures import ThreadPoolExecutor

    both = threading.Barrier(2, timeout=10)

    def fake_nvcc(cmd, **kwargs):
        with open(cmd[cmd.index("-o") + 1], "w") as fh:
            fh.write("lib")
        both.wait()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(kbuild, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(kbuild.subprocess, "run", fake_nvcc)
    with ThreadPoolExecutor(max_workers=2) as pool:
        paths = list(pool.map(lambda _: kbuild.build("k", str(csrc)),
                              range(2)))
    assert paths[0] == paths[1] and os.path.exists(paths[0])
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        [os.path.basename(paths[0]), os.path.basename(paths[0]) +
         ".ptxas.txt"])
