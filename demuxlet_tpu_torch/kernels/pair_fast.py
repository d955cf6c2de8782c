"""ctypes wrapper of K1 (``csrc/pair_fast.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair.py::_pair_kernel``.

Cost on this card: per slot the kernel reads 3V + C floats and spends
about V*V*A logs and 3*V*V*A FMAs, on the FP32 pipes and the log; the
function needs one log per channel per cell, so its bound is the bytes. Design: one block per cell looping over
all its slots, warps over (j, alpha) accumulator rows, lanes over slots
(coalesced along s), sums in registers and a fixed warp-shuffle reduction
(no atomics, so runs are bit-reproducible). See the source for details.

The wrapper validates its inputs, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if ``cudaGetLastError`` is not 0, and counts launches in
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from demuxlet_tpu_torch.kernels import build as kbuild

launches = 0  # kernel launches since import or the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = kbuild.load("pair_fast")
    fn = lib.dmx_pair_fast
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pair_fast(t, gps_t, V, A, a0_sep, sym_a, expand):
    """Launch K1. t (C, B, S) and gps_t (3V, B, S) contiguous float32 on
    one CUDA device; returns (llk_ab (B, V, V, A), llk_00 (B, A))."""
    global launches
    for name, x in (("t", t), ("gps_t", gps_t)):
        if not x.is_cuda:
            raise ValueError(f"pair_fast: {name} is not a CUDA tensor")
        if x.dtype != torch.float32:
            raise ValueError(f"pair_fast: {name} must be float32, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pair_fast: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"pair_fast: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if gps_t.shape != (3 * V, B, S) or gps_t.device != t.device:
        raise ValueError(
            f"pair_fast: gps_t {tuple(gps_t.shape)} on {gps_t.device} does "
            f"not match t {tuple(t.shape)} on {t.device} with V={V}"
        )
    if not 1 <= V <= 19 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"pair_fast: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"pair_fast: expand indexes outside the {C} "
                         "channels of t")
    out_ab = torch.empty((B, V * V * A), dtype=torch.float32,
                         device=t.device)
    out_00 = torch.empty((B, A), dtype=torch.float32, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.dmx_pair_fast(
            t.data_ptr(), gps_t.data_ptr(), exp_dev.data_ptr(),
            out_ab.data_ptr(), out_00.data_ptr(), B, S, V, A,
            int(bool(a0_sep)), -1 if sym_a is None else int(sym_a), stream,
        )
        if rc != 0:
            msg = lib.dmx_cuda_error_string(rc).decode()
            raise RuntimeError(f"pair_fast launch failed: {msg} ({rc})")
        launches += 1
    return out_ab.view(B, V, V, A), out_00
