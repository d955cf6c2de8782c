"""Build the port's CUDA kernels with nvcc into ``build/kernels/``.

Route: nvcc by hand into a shared library with a plain C interface,
loaded with ctypes (no PyTorch headers, so a build takes seconds). The
library is built from the sources in ``demuxlet_tpu_torch/csrc`` at first
use and named by a hash of its source, the headers beside it and the nvcc
flags (``source_digest``), so an edited source or header never loads a
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


def source_digest(name: str, csrc: str = CSRC, flags=NVCC_FLAGS) -> str:
    """sha256 (hex) of what a build of csrc/<name>.cu reads: the source,
    every header in csrc (``*.cuh``, ``*.h``, by name) and the flags."""
    headers = sorted(f for f in os.listdir(csrc) if f.endswith((".cuh", ".h")))
    digest = hashlib.sha256(repr(tuple(flags)).encode())
    for fname in [name + ".cu", *headers]:
        with open(os.path.join(csrc, fname), "rb") as fh:
            data = fh.read()
        digest.update(f"{fname}\0{len(data)}\0".encode() + data)
    return digest.hexdigest()


def build(name: str, csrc: str = CSRC, defines=()) -> str:
    """Compile csrc/<name>.cu (if its hashed library is absent) and return
    the library path. ``csrc`` and ``defines`` (``-D`` macros) build another
    tree or a variant of it, side by side. A failed compile raises with
    nvcc's output."""
    src = os.path.join(csrc, name + ".cu")
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    digest = source_digest(name, csrc, flags)
    out = os.path.join(BUILD_DIR, f"lib{name}_{digest[:12]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one temporary file per build: threads of one process may build the
    # same library at once (chip_steps.py's variants can share a digest)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [nvcc_path(), *flags, "-o", tmp, src]
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


def launch(lib: ctypes.CDLL, entry: str, device, *args) -> None:
    """Call the C entry point `entry` of `lib` with `args` and then the
    current stream of `device`, with `device` the current card: the CUDA
    runtime launches on the thread's current card, whatever card the
    tensors lie on. A non-zero return code raises."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        msg = lib.dmx_cuda_error_string(rc).decode()
        raise RuntimeError(
            f"{entry.removeprefix('dmx_')} launch failed: {msg} ({rc})")


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
