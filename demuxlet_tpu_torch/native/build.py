"""Build the native shared libraries (ingest + output renderer).

Usage: python demuxlet_tpu_torch/native/build.py
Produces _ingest.so and _render.so next to this file; the package falls
back to the pure Python ingest/renderer when a library is absent or
fails to load.
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "ingest.cpp")
OUT = os.path.join(HERE, "_ingest.so")


def build(force: bool = False) -> str:
    # staleness check covers every source the TU includes (#include
    # "cram_reader.inc"), not just the .cpp — a stale .so from an .inc
    # edit silently shipped old decode semantics (round-4 fuzz catch)
    deps = [SRC, os.path.join(HERE, "cram_reader.inc")]
    if (
        not force
        and os.path.exists(OUT)
        and os.path.getmtime(OUT) >= max(os.path.getmtime(d) for d in deps)
    ):
        return OUT
    # temp + rename: concurrent builders (distributed shards) must never
    # dlopen a half-written .so
    tmp = OUT + ".tmp%d" % os.getpid()
    cmd = [
        "g++",
        "-O2",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-o",
        tmp,
        SRC,
        "-lz",
        "-llzma",
        "-lpthread",
        "-ldl",
    ]
    subprocess.run(cmd, check=True)
    os.replace(tmp, OUT)
    return OUT


if __name__ == "__main__":
    path = build(force="--force" in sys.argv)
    print(path)
    # script-style invocation: repo root is not on sys.path
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    from demuxlet_tpu_torch.native.prep import build as build_prep
    from demuxlet_tpu_torch.native.render import build as build_render

    print(build_render(force="--force" in sys.argv))
    print(build_prep(force="--force" in sys.argv))
