"""ctypes wrapper of K6' (``csrc/extras_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_extras_kernel_df``.

Cost on this card: one f64 log per column per slot (~3V + A columns), on
the SMs' f64 pipes, a small share of K7''s; the function's bound is the
bytes of g (one log per column per cell would do). Design: one block per cell,
warps over columns, lanes over slots, a fixed warp-shuffle reduction, so
runs are bit-reproducible. See the source.

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
    lib = kbuild.load("extras_exact")
    fn = lib.dmx_extras_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def extras(t, g, gl, V, A, a0_sep, expand):
    """Launch K6'. t (C, B, S), g (3V+3, B, S) and gl (3, B, S) contiguous
    float64 on one CUDA device; returns (B, len(extras_keys)) float64."""
    global launches
    for name, x in (("t", t), ("g", g), ("gl", gl)):
        if not x.is_cuda:
            raise ValueError(f"extras: {name} is not a CUDA tensor")
        if x.dtype != torch.float64:
            raise ValueError(f"extras: {name} must be float64, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"extras: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"extras: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if g.shape != (3 * V + 3, B, S) or gl.shape != (3, B, S) \
            or g.device != t.device or gl.device != t.device:
        raise ValueError(
            f"extras: g {tuple(g.shape)} on {g.device} and gl "
            f"{tuple(gl.shape)} on {gl.device} do not match t "
            f"{tuple(t.shape)} on {t.device} with V={V}")
    if V < 1 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"extras: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"extras: expand indexes outside the {C} "
                         "channels of t")
    n_x = len(extras_keys(V, A, a0_sep))
    # no slots: every sum is empty, so the outputs are exact zeros
    out = (torch.empty if S else torch.zeros)(
        (B, n_x), dtype=torch.float64, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.dmx_extras_exact(
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            out.data_ptr(), B, S, V, A, int(bool(a0_sep)), stream,
        )
        if rc != 0:
            msg = lib.dmx_cuda_error_string(rc).decode()
            raise RuntimeError(f"extras launch failed: {msg} ({rc})")
        launches += 1
    return out
