"""ctypes wrapper of K2' (``csrc/front_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_onehot_front_kernel`` and of the
normalisation preamble of ``_pair_kernel_df``.

Bound on this card: per slot it writes C + 3 doubles against U*C LUT reads
and C exps, so it is bound by HBM bandwidth on its outputs. Design: one
thread per (cell, slot), slots fastest (coalesced stores), the LUT staged
in shared memory when it fits ``SMEM_MAX`` bytes, else read through L1.
See the source for details.

The wrapper validates its inputs, allocates the outputs with
``torch.empty``, launches on the current stream without synchronising,
raises if the launch reports a CUDA error, and counts launches in
``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from demuxlet_tpu_torch.kernels import build as kbuild

launches = 0  # kernel launches since import or the last reset_launches()

# LUTs up to this many bytes are staged in shared memory (two blocks of 256
# threads still fit an SM); larger ones are read through L1
SMEM_MAX = 96 * 1024


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = kbuild.load("front_exact")
    fn = lib.dmx_front_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, ctypes.c_longlong, I, I, I, I, I, I,
                       I, P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def front_exact(codes, lut, msk, cmask, gsel):
    """Launch K2'. codes (B, S, U) int32, lut (R, C) float64 (none row
    last), msk (B, S) bool, all contiguous on one CUDA device; cmask: C
    bools (the mixture channels); gsel: the 3 singlet channels.
    Returns (t (C, B, S), gl (3, B, S)) float64."""
    global launches
    for name, x, dtype, dim in (("codes", codes, torch.int32, 3),
                                ("lut", lut, torch.float64, 2),
                                ("msk", msk, torch.bool, 2)):
        if not x.is_cuda:
            raise ValueError(f"front_exact: {name} is not a CUDA tensor")
        if x.dtype != dtype:
            raise ValueError(f"front_exact: {name} must be {dtype}, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"front_exact: {name} must be contiguous")
        if x.dim() != dim:
            raise ValueError(f"front_exact: {name} must be {dim}-D, "
                             f"got {tuple(x.shape)}")
    B, S, U = codes.shape
    R, C = lut.shape
    if msk.shape != (B, S) or lut.device != codes.device \
            or msk.device != codes.device:
        raise ValueError(
            f"front_exact: msk {tuple(msk.shape)} on {msk.device} and lut on "
            f"{lut.device} do not match codes {tuple(codes.shape)} on "
            f"{codes.device}")
    if R < 1 or len(cmask) != C or not any(cmask) or len(gsel) != 3 \
            or min(gsel) < 0 or max(gsel) >= C:
        raise ValueError(f"front_exact: bad channel maps for C={C}: "
                         f"cmask {cmask}, gsel {gsel}")
    t = torch.empty((C, B, S), dtype=torch.float64, device=codes.device)
    gl = torch.empty((3, B, S), dtype=torch.float64, device=codes.device)
    if B * S:
        lib = _lib()
        cm = kbuild.int_table(codes.device, [bool(c) for c in cmask])
        stream = torch.cuda.current_stream(codes.device).cuda_stream
        rc = lib.dmx_front_exact(
            codes.data_ptr(), lut.data_ptr(), msk.data_ptr(), cm.data_ptr(),
            t.data_ptr(), gl.data_ptr(), B * S, U, R, C, int(gsel[0]),
            int(gsel[1]), int(gsel[2]), int(R * C * 8 <= SMEM_MAX), stream,
        )
        if rc != 0:
            msg = lib.dmx_cuda_error_string(rc).decode()
            raise RuntimeError(f"front_exact launch failed: {msg} ({rc})")
        launches += 1
    return t, gl
