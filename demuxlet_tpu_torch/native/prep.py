"""ctypes bindings for the native block prep (_prep.so).

Replaces host/csr.build_codes_block + engine._shrink_codes_blk on the
production wire path: one C pass over the block's CSR slice emits the
shrunk form (codes, (d8, base, fix_pos, fix_val), None) directly. The
numpy pipeline was the WARM end-to-end bottleneck at 100K cells
(benchmarks/probe_block_marginal.py: prep 279 ms/2048-cell block vs
H2D+step 167 ms). Falls back to the Python path when the library can't
build/load, input is unsorted (negative slot delta), or the fix list
outgrows the delta encoding (same conditions as _shrink_codes_blk).

Output arrays are BIT-IDENTICAL to the Python path — including 255
holes at dropped allele==2 lane positions and the resulting U bucket —
so device results match exactly in both modes whether or not the
library is present (the exact pair-LUT front pairs codes two-at-a-time;
even hole-position changes would shift df ulps across hosts). Pinned by
tests/test_native.py::test_native_prep_matches_python.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess

import numpy as np

_LIB = None
_LOAD_FAILED = False

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "prep.cpp")
OUT = os.path.join(HERE, "_prep.so")


def build(force: bool = False) -> str:
    # staleness check over ALL sources the TU includes, mirroring
    # native/build.py — an added #include must not silently ship a stale
    # _prep.so (the exact failure mode the round-4 fuzz catch fixed for
    # _ingest.so). prep.cpp currently has no local includes; list any
    # future .inc here.
    deps = [SRC]
    if (
        not force
        and os.path.exists(OUT)
        and os.path.getmtime(OUT) >= max(os.path.getmtime(d) for d in deps)
    ):
        return OUT
    tmp = OUT + ".tmp%d" % os.getpid()
    subprocess.run(
        ["g++", "-O2", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-o", tmp, SRC],
        check=True,
    )
    os.replace(tmp, OUT)
    return OUT


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _load():
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    if os.environ.get("DEMUX_TPU_NO_NATIVE_PREP"):
        _LOAD_FAILED = True
        return None
    try:
        lib = C.CDLL(build())
        dims = lib.dmx_prep_dims
        dims.restype = C.c_int
        dims.argtypes = [_I64P, _I32P, _U8P, _I64P, C.c_int64, _I64P]
        fill = lib.dmx_prep_fill
        fill.restype = C.c_int
        fill.argtypes = [
            _I64P, _I32P, _U8P, _U8P, _I64P, C.c_int64,
            C.c_int64, C.c_int64, C.c_int64, C.c_int64, C.c_int64,
            _U8P, _U8P, _I32P, _I32P, _I32P,
        ]
        d2 = lib.dmx_pack2_dims
        d2.restype = C.c_int
        d2.argtypes = [_I64P, _I32P, _U8P, _I64P, C.c_int64, C.c_int64,
                       _I64P, C.c_int64, _I64P]
        f2 = lib.dmx_pack2_fill
        f2.restype = C.c_int
        f2.argtypes = [
            _I64P, _I32P, _U8P, _U8P, _I64P, C.c_int64,
            C.c_int64, _U8P, C.c_int64, C.c_int64, C.c_int64,
            C.c_int64, C.c_int64, C.c_int64,
            C.c_int64, C.c_int64, C.c_int64, C.c_int64,
            _I32P, C.c_int64,
        ]
        _LIB = lib
    except Exception:
        _LOAD_FAILED = True
        return None
    return _LIB


def available() -> bool:
    return _load() is not None


def prep_block_shrunk(csr, cell_ids, cap_bq=40, pad_slots_to=128,
                      pad_cells_to=32):
    """Native build+shrink: returns (codes, (d8, base, fix_pos, fix_val),
    None) — the engine._shrink_codes_blk delta contract — or None to
    signal Python fallback (library unavailable, unsorted slice, or fix
    list too wide for the delta encoding)."""
    lib = _load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(np.asarray(cell_ids, dtype=np.int64))
    B = len(ids)
    cell_ptr = csr.cell_ptr
    obs_snp = csr.obs_snp
    obs_al = csr.obs_allele
    obs_bq = csr.obs_bq
    assert (cell_ptr.dtype == np.int64 and obs_snp.dtype == np.int32
            and obs_al.dtype == np.uint8 and obs_bq.dtype == np.uint8)
    dims = np.zeros(4, dtype=np.int64)
    lib.dmx_prep_dims(cell_ptr, obs_snp, obs_al, ids, B, dims)
    smax, umax, kmax, flags = (int(x) for x in dims)
    pad_slots_to = max(pad_slots_to, 128)
    pad_cells_to = max(pad_cells_to, 32)
    if pad_cells_to % 32:
        pad_cells_to = -(-pad_cells_to // 32) * 32
    Sp = max(pad_slots_to, -(-max(smax, 1) // pad_slots_to) * pad_slots_to)
    Bp = max(pad_cells_to, -(-B // pad_cells_to) * pad_cells_to)
    if flags & 1 or kmax > Sp // 8:
        return None  # unsorted / fix list too wide -> Python path
    U = 1
    while U < umax:
        U *= 2
    Kp = 8
    while Kp < kmax:
        Kp *= 2
    codes = np.empty((Bp, Sp, U), dtype=np.uint8)
    d8 = np.empty((Bp, Sp), dtype=np.uint8)
    base = np.empty(Bp, dtype=np.int32)
    fix_pos = np.empty((Bp, Kp), dtype=np.int32)
    fix_val = np.empty((Bp, Kp), dtype=np.int32)
    lib.dmx_prep_fill(cell_ptr, obs_snp, obs_al, obs_bq, ids, B,
                      cap_bq, Sp, U, Kp, Bp,
                      codes, d8, base, fix_pos, fix_val)
    return codes, (d8, base, fix_pos, fix_val), None


def pack_block_v2(csr, cell_ids, cfg, cap_bq=40, pad_slots_to=128,
                  pad_cells_to=32, floors=None, floors_for=None):
    """Native single-pass wire-v2 block pack: (wire (Bp, W) i32, meta),
    byte-identical to host.wire.pack_wire_block (pinned by
    tests/test_native.py), or None to signal the Python fallback
    (library unavailable / unsorted slice). The Python route
    materializes the dense (B, S, U) code tensor (~270M u8 on deep-U
    realistic blocks, 2.4-3 s/block); here each cell's observations
    stream once through C.

    floors = (u0_pin, k2p_floor, kp_floor) from the engine's meta
    registry (host/wire._assemble contract)."""
    lib = _load()
    if lib is None:
        return None
    ids = np.ascontiguousarray(np.asarray(cell_ids, dtype=np.int64))
    B = len(ids)
    cell_ptr, obs_snp = csr.cell_ptr, csr.obs_snp
    obs_al, obs_bq = csr.obs_allele, csr.obs_bq
    assert (cell_ptr.dtype == np.int64 and obs_snp.dtype == np.int32
            and obs_al.dtype == np.uint8 and obs_bq.dtype == np.uint8)
    cw, dw = cfg.code_w, cfg.delta_w
    E = (1 << dw) - 1

    cands = []
    c = 1
    while c <= 0x10000:  # pow2 U buckets up to 2^16 (deeper -> fallback)
        cands.append(c)
        c *= 2
    cands_a = np.asarray(cands, dtype=np.int64)
    dims = np.zeros(4 + len(cands), dtype=np.int64)
    lib.dmx_pack2_dims(cell_ptr, obs_snp, obs_al, ids, B, E,
                       cands_a, len(cands), dims)
    smax, umax, kmax, flags = (int(x) for x in dims[:4])
    tails_max = {c: int(t) for c, t in zip(cands, dims[4:])}
    if flags & 1:
        return None  # unsorted -> Python path

    pad_slots_to = max(pad_slots_to, 128)
    pad_cells_to = max(pad_cells_to, 32)
    if pad_cells_to % 32:
        pad_cells_to = -(-pad_cells_to // 32) * 32
    Sp = max(pad_slots_to, -(-max(smax, 1) // pad_slots_to) * pad_slots_to)
    Bp = max(pad_cells_to, -(-B // pad_cells_to) * pad_cells_to)
    if Sp > 0xFFFF:
        return None  # u16 fix/tail positions can't address the slots
    U = 1
    while U < umax:
        U *= 2
    if U > cands[-1]:
        # dims only tallied tails up to the last candidate; a deeper
        # block (pathological >2^16-deep slot) falls back to the Python
        # packer rather than mis-sizing K2p (silent tail truncation)
        return None

    if floors is None and floors_for is not None:
        floors = floors_for((Sp, U))  # engine meta-registry lookup
    u0_pin, k2p_floor, kp_floor = floors if floors else (None, 16, 8)

    # half-pow2 size ladder + tail width rule shared with the Python
    # packer — the two routes must emit identical metas (test_native
    # pins byte parity)
    from demuxlet_tpu_torch.host.wire import _tail_width, size_bucket as bucket

    if u0_pin is not None:
        U0 = min(u0_pin, U)
    elif not cfg.adaptive:
        U0 = min(cfg.u_cap, U)
    else:
        # mirror host.wire._choose_u0's cost model on the dims stats
        best_u0, best_cost = U, Sp * U * cw / 8.0
        c = 1
        while c < U:
            K2p_c = bucket(tails_max[c], 16)
            tw_c = _tail_width(Sp, U, c)
            cost = Sp * c * cw / 8.0 + K2p_c * (tw_c / 8.0 + cw / 8.0)
            if cost < best_cost:
                best_u0, best_cost = c, cost
            c *= 2
    # (loop variable naming: best_u0 only set in the adaptive branch)
    if u0_pin is None and cfg.adaptive:
        U0 = best_u0

    if U == U0:
        K2p, tw = 0, 16
    else:
        tw = _tail_width(Sp, U, U0)
        K2p = bucket(max(tails_max.get(U0, 0), k2p_floor, 1), 16)
    Kp = bucket(max(kmax, kp_floor, 1), 8)

    codes_b = Sp * U0 * cw // 8
    tpos_b = K2p * (tw // 8)
    tcode_b = K2p * cw // 8
    delta_b = Sp * dw // 8
    W = (codes_b + tpos_b + tcode_b + delta_b + 4 + Kp * 2 + Kp * 4) // 4
    wire = np.empty((Bp, W), dtype=np.int32)
    lib.dmx_pack2_fill(cell_ptr, obs_snp, obs_al, obs_bq, ids, B,
                       cap_bq, cfg.code_lut(), cfg.n_real, cw, dw,
                       Sp, U, U0, K2p, Kp, tw, Bp, wire, W)
    meta = ("w2", Sp, U, U0, K2p, Kp, cw, dw, cfg.n_real, tw)
    return wire, meta
