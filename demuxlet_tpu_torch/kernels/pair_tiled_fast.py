"""ctypes wrapper of K5' (``csrc/pair_tiled_fast.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair.py::_pair_kernel_tiled``.

Cost on this card: per slot the function reads 3V + the used t channels
(floats) and spends a 3-term dot and a multiply per (j, k, alpha)
channel, so bytes bound it at V=32, A=2 (0.26 ms at B=2048, S=1024) and
f32 operations at A=5. Design: K7''s (``csrc/tiled.cuh``, the body both
share) in f32. One (cell, tile) per block streams the cell's slots
through shared memory in chunks of 128 (``csrc/stage.cuh``); each warp
owns a 4 x 8 patch of (j, k) channels of one alpha; each channel keeps an
f32 product with exponent tracking and takes one f64 log per lane
(``csrc/logprod.cuh``), then a fixed f64 warp-shuffle reduction rounded
to f32 once, so runs are bit-reproducible; the symmetric plane runs on
upper-triangle tiles and is mirrored. 1.75 ms at that shape on an H100
80GB HBM3 at 700 W (5.74 ms for the first, logf-per-slot kernel;
PERF.md).
See the source.

The wrapper validates its inputs, allocates the output with
``torch.zeros`` (the separable alpha == 0 plane, which no tile writes,
stays 0 for the reassembly), launches on the current stream without
synchronising, raises if ``cudaGetLastError`` is not 0, and counts
launches in ``launches``.
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
    lib = kbuild.load("pair_tiled_fast")
    fn = lib.dmx_pair_tiled_fast
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_pair_tiled_fast_smem.argtypes = [I]
        lib.dmx_pair_tiled_fast_smem.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(tile) -> int:
    """The dynamic shared memory K5' takes with tile extent ``tile``."""
    return _lib().dmx_pair_tiled_fast_smem(tile)


def pair_tiled_fast(t, gps_t, V, A, plan, expand):
    """Launch K5'. t (C, B, S) and gps_t (3V, B, S) contiguous float32 on
    one CUDA device; plan: ``ops/pair_tiled.TilePlan``. Returns llk_ab
    (B, V, V, A) float32, the planned alphas filled, the rest 0."""
    global launches
    for name, x in (("t", t), ("gps_t", gps_t)):
        if not x.is_cuda:
            raise ValueError(f"pair_tiled_fast: {name} is not a CUDA tensor")
        if x.dtype != torch.float32:
            raise ValueError(f"pair_tiled_fast: {name} must be float32, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pair_tiled_fast: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"pair_tiled_fast: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if gps_t.shape != (3 * V, B, S) or gps_t.device != t.device:
        raise ValueError(
            f"pair_tiled_fast: gps_t {tuple(gps_t.shape)} on {gps_t.device} "
            f"does not match t {tuple(t.shape)} on {t.device} with V={V}")
    if V < 1 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"pair_tiled_fast: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"pair_tiled_fast: expand indexes outside the {C} "
                         "channels of t")
    if plan.tile not in (8, 16) or not plan.items or any(
            not 0 <= a < A for a in plan.alist):
        raise ValueError(f"pair_tiled_fast: unsupported plan {plan}")
    out = torch.zeros((B, V, V, A), dtype=torch.float32, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        items = kbuild.int_table(t.device, [v for it in plan.items
                                            for v in it])
        alist = kbuild.int_table(t.device, plan.alist)
        kbuild.launch(
            lib, "dmx_pair_tiled_fast", t.device,
            t.data_ptr(), gps_t.data_ptr(), exp_dev.data_ptr(),
            items.data_ptr(), alist.data_ptr(), out.data_ptr(), B, S, V, A,
            len(plan.items), plan.tile,
        )
        launches += 1
    return out
