"""ctypes wrapper of K4' (``csrc/extras_fast.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair.py::_extras_kernel``.

Bound on this card: the bytes of its rows (g, the host background rows
and the t rows its columns use), read once per cell; ~2V + A columns of a
3-term dot and a multiply per slot. It runs at ~1.3x that, its staging
and its arithmetic each near its time (PERF.md). Design: K6''s body
(``csrc/extras.cuh``) in f32 without the singlet columns, the background
rows through their own pointer: one block per cell streams its slots
through shared-memory stages; each warp owns a sample's d and gs columns
or an alpha's m0 column and keeps each column's sum of logs as a product
with exponent tracking (``csrc/logprod.cuh``): one log per lane and
column, a fixed warp-shuffle reduction, so runs are bit-reproducible. See
the source.

The wrapper validates its inputs, allocates the output with
``torch.empty``, launches on the current stream without synchronising,
raises if ``cudaGetLastError`` is not 0, and counts launches in
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from demuxlet_tpu_torch.kernels import build as kbuild
from demuxlet_tpu_torch.ops.pair_tiled import extras_keys

launches = 0  # kernel launches since import or the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = kbuild.load("extras_fast")
    fn = lib.dmx_extras_fast
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_extras_fast_smem.argtypes = [I, I, I]
        lib.dmx_extras_fast_smem.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(V, A, a0_sep) -> int:
    """The dynamic shared memory K4' takes for a pool (bytes)."""
    lib = _lib()
    return int(lib.dmx_extras_fast_smem(V, A, int(bool(a0_sep))))


def extras_fast(t, gps_t, gp0_t, V, A, a0_sep, expand):
    """Launch K4'. t (C, B, S), gps_t (3V, B, S) and gp0_t (3, B, S)
    contiguous float32 on one CUDA device; returns (B, len(extras_keys(V,
    A, a0_sep, singlets=False))) float32."""
    global launches
    for name, x in (("t", t), ("gps_t", gps_t), ("gp0_t", gp0_t)):
        if not x.is_cuda:
            raise ValueError(f"extras_fast: {name} is not a CUDA tensor")
        if x.dtype != torch.float32:
            raise ValueError(f"extras_fast: {name} must be float32, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"extras_fast: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"extras_fast: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if gps_t.shape != (3 * V, B, S) or gp0_t.shape != (3, B, S) \
            or gps_t.device != t.device or gp0_t.device != t.device:
        raise ValueError(
            f"extras_fast: gps_t {tuple(gps_t.shape)} on {gps_t.device} and "
            f"gp0_t {tuple(gp0_t.shape)} on {gp0_t.device} do not match t "
            f"{tuple(t.shape)} on {t.device} with V={V}")
    if V < 1 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"extras_fast: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"extras_fast: expand indexes outside the {C} "
                         "channels of t")
    n_x = len(extras_keys(V, A, a0_sep, singlets=False))
    # no slots: every sum is empty, so the outputs are exact zeros
    out = (torch.empty if S else torch.zeros)(
        (B, n_x), dtype=torch.float32, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        kbuild.launch(
            lib, "dmx_extras_fast", t.device,
            t.data_ptr(), gps_t.data_ptr(), gp0_t.data_ptr(),
            exp_dev.data_ptr(), out.data_ptr(), B, S, V, A,
            int(bool(a0_sep)),
        )
        launches += 1
    return out
