"""ctypes wrapper of K3' (``csrc/pair_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_pair_kernel_df``.

Cost on this card: per slot the kernel reads 3V + 6 + C doubles and
spends about V*V*A f64 logs, on the f64 pipes; the function needs one log
per channel per cell, so its bound is the bytes. Design: K1's
(one block per cell looping over its slots, warps over (j, alpha) rows,
lanes over slots, sums in registers and a fixed warp-shuffle reduction, so
runs are bit-reproducible), in f64, with the singlet row as one more task.
See the source for details.

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
    lib = kbuild.load("pair_exact")
    fn = lib.dmx_pair_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def pair_exact(t, g, gl, V, A, a0_sep, sym_a, expand):
    """Launch K3'. t (C, B, S), g (3V+3, B, S) and gl (3, B, S) contiguous
    float64 on one CUDA device; returns (llk_ab (B, V, V, A), llk_00 (B, A),
    llk (B, V), llk0 (B,)) float64."""
    global launches
    for name, x in (("t", t), ("g", g), ("gl", gl)):
        if not x.is_cuda:
            raise ValueError(f"pair_exact: {name} is not a CUDA tensor")
        if x.dtype != torch.float64:
            raise ValueError(f"pair_exact: {name} must be float64, "
                             f"got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pair_exact: {name} must be contiguous")
        if x.dim() != 3:
            raise ValueError(f"pair_exact: {name} must be 3-D, "
                             f"got {tuple(x.shape)}")
    C, B, S = t.shape
    if g.shape != (3 * V + 3, B, S) or gl.shape != (3, B, S) \
            or g.device != t.device or gl.device != t.device:
        raise ValueError(
            f"pair_exact: g {tuple(g.shape)} on {g.device} and gl "
            f"{tuple(gl.shape)} on {gl.device} do not match t "
            f"{tuple(t.shape)} on {t.device} with V={V}")
    if not 1 <= V <= 20 or A < 1 or len(expand) != A * 9:
        raise ValueError(f"pair_exact: unsupported V={V}, A={A}, "
                         f"len(expand)={len(expand)}")
    if min(expand) < 0 or max(expand) >= C:
        raise ValueError(f"pair_exact: expand indexes outside the {C} "
                         "channels of t")
    # no slots: every sum is empty, so the outputs are exact zeros
    new = torch.empty if S else torch.zeros
    kw = dict(dtype=torch.float64, device=t.device)
    out_ab = new((B, V * V * A), **kw)
    out_00 = new((B, A), **kw)
    out_s = new((B, V), **kw)
    out_s0 = new((B,), **kw)
    if B and S:
        lib = _lib()
        exp_dev = kbuild.int_table(t.device, expand)
        stream = torch.cuda.current_stream(t.device).cuda_stream
        rc = lib.dmx_pair_exact(
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            out_ab.data_ptr(), out_00.data_ptr(), out_s.data_ptr(),
            out_s0.data_ptr(), B, S, V, A, int(bool(a0_sep)),
            -1 if sym_a is None else int(sym_a), stream,
        )
        if rc != 0:
            msg = lib.dmx_cuda_error_string(rc).decode()
            raise RuntimeError(f"pair_exact launch failed: {msg} ({rc})")
        launches += 1
    return out_ab.view(B, V, V, A), out_00, out_s, out_s0
