"""ctypes wrapper of K3' (``csrc/pair_exact.cu``), the Hopper port of
``demuxlet_tpu/ops/pallas_pair_exact.py::_pair_kernel_df``.

Cost on this card: per slot the function reads 3V + 6 + C doubles and
spends a 3-term dot and a multiply per channel, so its bound is the bytes
(0.24 ms at B=2048, S=1024, V=8, A=5). Design: one block per cell streams
its slots through shared memory in chunks (``csrc/stage.cuh``); each warp
owns a 4 x 4 patch of (j, k) channels of one alpha and up to 4 of the
O(V) channels; each channel keeps a product with exponent tracking and
takes one log per lane (``csrc/logprod.cuh``), then a fixed warp-shuffle
reduction, so runs are bit-reproducible. 1.19 ms at that shape on an H100
80GB HBM3 at 700 W (6.48 ms for PR 4's log-per-slot kernel; PERF.md). See
the source for details.

Its stages hold all C rows of t, so V=1 grids of 162 alphas or more do
not fit; ``k3_fits`` says so without the library, and
``ops/pair_exact.pair_exact`` sends those pools to the tiled K7' + K6'.

The wrapper validates its inputs (including that the shared-memory stages
fit: ``smem_bytes``), allocates the outputs with ``torch.empty``, launches
on the current stream without synchronising, raises if
``cudaGetLastError`` is not 0, and counts launches in ``launches``.
"""

from __future__ import annotations

import ctypes

import torch

from demuxlet_tpu_torch.kernels import build as kbuild

launches = 0  # kernel launches since import or the last reset_launches()

# csrc/pair_exact.cu's kSmemMax and csrc/stage.cuh's patch (PJ x PK)
SMEM_MAX = 190 * 1024
_PJ = _PK = 4


def reset_launches() -> None:
    global launches
    launches = 0


def _lib():
    lib = kbuild.load("pair_exact")
    fn = lib.dmx_pair_exact
    if fn.argtypes is None:
        P = ctypes.c_void_p
        I = ctypes.c_int
        fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, P]
        fn.restype = I
        lib.dmx_pair_exact_smem.argtypes = [I, I, I, I]
        lib.dmx_pair_exact_smem.restype = I
        lib.dmx_cuda_error_string.argtypes = [I]
        lib.dmx_cuda_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(V, A, C, a0_sep) -> int:
    """The dynamic shared memory K3' takes at this shape (0: its stages do
    not fit)."""
    return _lib().dmx_pair_exact_smem(V, A, C, int(bool(a0_sep)))


def k3_fits(V, A, C, a0_sep) -> bool:
    """Whether K3''s two shared-memory stages fit at this shape (V samples,
    A alphas, C rows of t): ``smem_bytes(...) != 0`` without the library,
    mirroring ``shape_params``, ``smem_bytes`` and ``chunk_for`` of
    ``csrc/pair_exact.cu`` (a chunk of 128 slots, else 16 at V <= 8 and 64
    at V <= 20). a0_sep does not change the stages."""
    del a0_sep
    if not 1 <= V <= 20:
        return False
    nk = -(-V // _PK)
    rows = 3 * max(V + 1, -(-V // _PJ) * _PJ, nk * _PK) + 3 + C

    def smem(ch):
        return 2 * rows * ch * 8 + rows * 8 + 9 * A * 4

    return smem(128) <= SMEM_MAX or smem(16 if V <= 8 else 64) <= SMEM_MAX


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
        if not smem_bytes(V, A, C, a0_sep):
            raise ValueError(f"pair_exact: V={V}, A={A} and C={C} channels "
                             "do not fit the kernel's shared-memory stages")
        exp_dev = kbuild.int_table(t.device, expand)
        kbuild.launch(
            lib, "dmx_pair_exact", t.device,
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            out_ab.data_ptr(), out_00.data_ptr(), out_s.data_ptr(),
            out_s0.data_ptr(), B, S, V, A, C, int(bool(a0_sep)),
            -1 if sym_a is None else int(sym_a),
        )
        launches += 1
    return out_ab.view(B, V, V, A), out_00, out_s, out_s0
