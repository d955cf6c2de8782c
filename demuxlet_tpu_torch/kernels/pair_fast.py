"""ctypes wrapper of K1 (``csrc/pair_fast.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair.py::_pair_kernel``.

Cost on this card: per slot the function reads 3V + C floats and spends a
3-term dot and a multiply per channel, so its bound is the bytes (0.10 ms
at B=2048, S=1024, V=8, A=5). Design: K3''s (``kernels/pair_exact.py``)
in f32, without singlets. One block per cell streams its slots through
shared memory in chunks of 128 (``csrc/stage.cuh``), with the background
rows g0 (the f32 sample mean in j order) computed into each chunk; each
warp owns a 4 x 8 patch of (j, k) channels of one alpha and up to 4 of
the O(V) channels; each channel keeps an f32 product with exponent
tracking and takes one f64 log per lane (``csrc/logprod.cuh``), then a
fixed f64 warp-shuffle reduction rounded to f32 once, so runs are
bit-reproducible. A round of warps stages only its own alphas' t rows, so
shared memory does not grow with A: every V*V*A <= 384 shape launches.
0.83 ms at that shape on an H100 80GB HBM3 at 700 W (2.09 ms for the
first, logf-per-slot kernel; PERF.md). See the source for details.

The wrapper validates its inputs, allocates the outputs with
``torch.empty`` (``torch.zeros`` when S == 0: every sum is empty),
launches on the current stream without synchronising, raises if
``cudaGetLastError`` is not 0, and counts launches in ``launches``.
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
        lib.dmx_pair_fast_smem.argtypes = [I, I, I]
        lib.dmx_pair_fast_smem.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(V, A, a0_sep) -> int:
    """The dynamic shared memory K1 takes at this shape (bytes)."""
    return _lib().dmx_pair_fast_smem(V, A, int(bool(a0_sep)))


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
    new = torch.empty if S else torch.zeros
    out_ab = new((B, V * V * A), dtype=torch.float32, device=t.device)
    out_00 = new((B, A), dtype=torch.float32, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        kbuild.launch(
            lib, "dmx_pair_fast", t.device,
            t.data_ptr(), gps_t.data_ptr(), exp_dev.data_ptr(),
            out_ab.data_ptr(), out_00.data_ptr(), B, S, V, A,
            int(bool(a0_sep)), -1 if sym_a is None else int(sym_a),
        )
        launches += 1
    return out_ab.view(B, V, V, A), out_00
