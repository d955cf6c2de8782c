"""ctypes wrapper of K7' (``csrc/pair_tiled_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_pair_kernel_df_tiled``.

Cost on this card: one f64 log per (j, k, alpha) channel per slot, on the
SMs' f64 pipes; the function needs one log per channel per cell, so its
bound is far lower (bytes at V=32, A=2). Design: K3''s layout over one (cell, tile) per block (warps
over (j, alpha) rows, lanes over slots, the tile's k sums in registers and
a fixed warp-shuffle reduction, so runs are bit-reproducible), the
symmetric plane on upper-triangle tiles and mirrored. See the source.

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
    lib = kbuild.load("pair_tiled_exact")
    fn = lib.dmx_pair_tiled_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pair_tiled(t, g, V, A, plan, expand):
    """Launch K7'. t (C, B, S) and g (3V+3, B, S) contiguous float64 on one
    CUDA device; plan: ``ops/pair_tiled.TilePlan``. Returns llk_ab
    (B, V, V, A) float64, the planned alphas filled, the rest 0."""
    global launches
    for name, x in (("t", t), ("g", g)):
        if not x.is_cuda:
            raise ValueError(f"pair_tiled: {name} is not a CUDA tensor")
        if x.dtype != torch.float64:
            raise ValueError(f"pair_tiled: {name} must be float64, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pair_tiled: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"pair_tiled: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if g.shape != (3 * V + 3, B, S) or g.device != t.device:
        raise ValueError(
            f"pair_tiled: g {tuple(g.shape)} on {g.device} does not match "
            f"t {tuple(t.shape)} on {t.device} with V={V}")
    if V < 1 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"pair_tiled: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"pair_tiled: expand indexes outside the {C} "
                         "channels of t")
    if plan.tile not in (8, 16) or not plan.items or any(
            not 0 <= a < A for a in plan.alist):
        raise ValueError(f"pair_tiled: unsupported plan {plan}")
    out = torch.zeros((B, V, V, A), dtype=torch.float64, device=t.device)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        items = kbuild.int_table(t.device, [v for it in plan.items
                                            for v in it])
        alist = kbuild.int_table(t.device, plan.alist)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.dmx_pair_tiled_exact(
            t.data_ptr(), g.data_ptr(), exp_dev.data_ptr(), items.data_ptr(),
            alist.data_ptr(), out.data_ptr(), B, S, V, A, len(plan.items),
            plan.tile, stream,
        )
        if rc != 0:
            msg = lib.dmx_cuda_error_string(rc).decode()
            raise RuntimeError(f"pair_tiled launch failed: {msg} ({rc})")
        launches += 1
    return out
