"""Build the port's CUDA kernels with nvcc into ``build/kernels/``.

Route: nvcc by hand into a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library is built from the sources in ``demuxlet_tpu_torch/csrc`` at first
use and named by a hash of its source, so an edited source never loads a
stale library. Nothing is built when the package is imported.

Usage: python -m demuxlet_tpu_torch.kernels.build   (builds every
csrc/*.cu, one nvcc each, all started together, and prints the library
paths)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG), "build", "kernels")

# sm_90a: Hopper with its architecture-specific features. No
# --use_fast_math: the fast-mode contract needs the accurate logf.
# -Xptxas -v: ptxas reports each kernel's registers and spills, kept
# beside the library (``ptxas_report``).
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_tables: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "demuxlet_tpu_torch are built from source at first use"
    )


def build(name: str) -> str:
    """Compile csrc/<name>.cu (if its hashed library is absent) and return
    the library path. A failed compile raises with nvcc's output."""
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + repr(NVCC_FLAGS).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(out + ".ptxas.txt", "w") as fh:
        fh.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # a concurrent build never loads a partial file
    return out


def ptxas_report(lib_path: str) -> list:
    """ptxas's lines for a built library, per kernel instantiation: the
    entry it compiled, its stack frame and spills, its registers (empty if
    no report was kept)."""
    path = lib_path + ".ptxas.txt"
    if not os.path.exists(path):
        return []
    keep = ("Compiling entry", "spill stores", "Used ")
    with open(path) as fh:
        return [ln.replace("ptxas info    : ", "").strip()
                for ln in fh if any(k in ln for k in keep)]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libs[name] = lib
        return lib


def build_all() -> dict:
    """Build every csrc/<name>.cu with one nvcc each, all started
    together; returns {name: (library path, seconds)}. The first failed
    build raises."""
    import time

    names = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))

    def one(name):
        t0 = time.monotonic()
        return build(name), time.monotonic() - t0

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        futs = {name: pool.submit(one, name) for name in names}
        return {name: fut.result() for name, fut in futs.items()}


def int_table(device, values):
    """A cached int32 tensor of `values` on `device` (a kernel's static
    channel map or mask), uploaded once per device and value tuple."""
    key = (device, tuple(int(v) for v in values))
    with _lock:
        dev = _tables.get(key)
    if dev is None:
        dev = torch.tensor(key[1], dtype=torch.int32, device=device)
        with _lock:
            _tables[key] = dev
    return dev


if __name__ == "__main__":
    for _name, (_path, _secs) in build_all().items():
        print(f"{_name}: {_path} ({_secs:.1f} s)")
