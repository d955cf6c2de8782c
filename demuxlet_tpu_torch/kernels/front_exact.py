"""ctypes wrapper of K2' (``csrc/front_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_onehot_front_kernel`` and of the
normalisation preamble of ``_pair_kernel_df``.

Bound on this card: per slot it writes C + 3 doubles against its U0 dense
codes, its share of the wire-v2 tail, ~U0 + 1 LUT rows and C + 3 exps, so
its bound is the bytes of its outputs; it runs at 4-5x that, held by its
instructions (the exps, the lane loop, the binary searches; PERF.md). Design: one block per cell at a
time, one thread per slot, slots fastest (coalesced stores); the dense
lanes, then the slot's run of the sorted tail (a binary search of the
cell's tail, staged in shared memory up to ``TAIL_SMEM_MAX`` bytes), so the
deep lanes are never rebuilt; the LUT staged in shared memory when it fits
``SMEM_MAX`` bytes, else read through L1. See the source for details.

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
# a cell's tail (8 bytes an entry) up to this many bytes is staged too
TAIL_SMEM_MAX = 32 * 1024


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = kbuild.load("front_exact")
    fn = lib.dmx_front_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P] * 8 + [I] * 12 + [P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, x, dtype, dim):
    if not x.is_cuda:
        raise ValueError(f"front_exact: {name} is not a CUDA tensor")
    if x.dtype != dtype:
        raise ValueError(f"front_exact: {name} must be {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"front_exact: {name} must be contiguous")
    if x.dim() != dim:
        raise ValueError(f"front_exact: {name} must be {dim}-D, "
                         f"got {tuple(x.shape)}")


def front_exact(dense, lut, msk, cmask, gsel, tail=None, n_deep=0):
    """Launch K2'. dense (B, S, U0) int32 codes, lut (R, C) float64 (none
    row last), msk (B, S) bool, all contiguous on one CUDA device; tail:
    None (dense holds every lane) or the wire-v2 tail (tpos, tcode), each
    (B, K2p) int32 contiguous, tpos sorted per cell (slot * n_deep + the
    lane past U0; pads at S * n_deep or past it); n_deep: the deep lanes
    U - U0. cmask: C bools (the mixture channels); gsel: the 3 singlet
    channels. Returns (t (C, B, S), gl (3, B, S)) float64."""
    global launches
    _check("dense", dense, torch.int32, 3)
    _check("lut", lut, torch.float64, 2)
    _check("msk", msk, torch.bool, 2)
    B, S, U0 = dense.shape
    R, C = lut.shape
    if msk.shape != (B, S) or lut.device != dense.device \
            or msk.device != dense.device:
        raise ValueError(
            f"front_exact: msk {tuple(msk.shape)} on {msk.device} and lut on "
            f"{lut.device} do not match dense {tuple(dense.shape)} on "
            f"{dense.device}")
    if R < 1 or len(cmask) != C or not any(cmask) or len(gsel) != 3 \
            or min(gsel) < 0 or max(gsel) >= C:
        raise ValueError(f"front_exact: bad channel maps for C={C}: "
                         f"cmask {cmask}, gsel {gsel}")
    K2p, tpos, tcode = 0, None, None
    if tail is not None:
        tpos, tcode = tail
        _check("tpos", tpos, torch.int32, 2)
        _check("tcode", tcode, torch.int32, 2)
        K2p = tpos.shape[1]
        if tpos.shape != (B, K2p) or tcode.shape != (B, K2p) \
                or tpos.device != dense.device \
                or tcode.device != dense.device or n_deep < 1:
            raise ValueError(
                f"front_exact: tail {tuple(tpos.shape)}, "
                f"{tuple(tcode.shape)} with n_deep={n_deep} does not match "
                f"dense {tuple(dense.shape)} on {dense.device}")
    t = torch.empty((C, B, S), dtype=torch.float64, device=dense.device)
    gl = torch.empty((3, B, S), dtype=torch.float64, device=dense.device)
    if B * S:
        lib = _lib()
        cm = kbuild.int_table(dense.device, [bool(c) for c in cmask])
        kbuild.launch(
            lib, "dmx_front_exact", dense.device,
            dense.data_ptr(), tpos.data_ptr() if K2p else None,
            tcode.data_ptr() if K2p else None, lut.data_ptr(),
            msk.data_ptr(), cm.data_ptr(), t.data_ptr(), gl.data_ptr(), B, S,
            U0, K2p, n_deep if K2p else 0, R, C, int(gsel[0]), int(gsel[1]),
            int(gsel[2]), int(R * C * 8 <= SMEM_MAX),
            int(K2p * 8 <= TAIL_SMEM_MAX),
        )
        launches += 1
    return t, gl
