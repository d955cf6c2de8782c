"""The engine's wire-v2 block packer (``dmx_pack3_dims``/``dmx_pack3_fill``,
native/pack.cpp, built into _prep.so by native/prep.py).

``pack_block_v2`` takes ``native/prep.pack_block_v2``'s arguments and gives
its result: the same (Bp, W) int32 wire, byte for byte, and the same meta,
or None where it gives None (no library, an unsorted slice, more than
0xFFFF slots, a slot deeper than 2^16 lanes). Its native calls count a
slot's tail entries from one histogram a cell and write the bit streams a
word at a time. ``counts()`` reads the blocks packed here and those handed
back for the numpy packer, process-wide.
"""

from __future__ import annotations

import ctypes as C
import threading

import numpy as np

from demuxlet_tpu_torch.host.wire import _tail_width, size_bucket
from demuxlet_tpu_torch.native import prep

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

# pow2 U buckets up to 2^16 (a deeper slot goes to the numpy packer)
CANDS = np.asarray([1 << j for j in range(17)], dtype=np.int64)


_BOUND = None  # the library whose packer functions have their types set
_BIND = threading.Lock()


def _lib():
    """The loaded _prep.so with the packer bound, or None. The types are
    set once a library: the prefetch threads call concurrently, and ctypes
    must not have a function's argtypes replaced while another thread
    converts that function's arguments."""
    global _BOUND
    lib = prep._load()
    if lib is None or not hasattr(lib, "dmx_pack3_fill"):
        return None
    if _BOUND is not lib:
        with _BIND:
            if _BOUND is not lib:
                _bind(lib)
                _BOUND = lib
    return lib


def _bind(lib):
    lib.dmx_pack3_dims.restype = C.c_int
    lib.dmx_pack3_dims.argtypes = [_I64P, _I32P, _U8P, _I64P, C.c_int64,
                                   C.c_int64, _I64P, C.c_int64, _I64P]
    lib.dmx_pack3_fill.restype = C.c_int
    lib.dmx_pack3_fill.argtypes = [
        _I64P, _I32P, _U8P, _U8P, _I64P, C.c_int64, C.c_int64, _U8P,
        C.c_int64, C.c_int64, C.c_int64, C.c_int64, C.c_int64, C.c_int64,
        C.c_int64, C.c_int64, C.c_int64, C.c_int64, _I32P, C.c_int64,
    ]
    lib.dmx_pack3_fallback.restype = None
    lib.dmx_pack3_fallback.argtypes = []
    lib.dmx_pack_counts.restype = None
    lib.dmx_pack_counts.argtypes = [C.POINTER(C.c_int64)] * 2


def pack_block_v2(csr, cell_ids, cfg, cap_bq=40, pad_slots_to=128,
                  pad_cells_to=32, floors=None, floors_for=None):
    """(wire (Bp, W) i32, meta) of the block of ``cell_ids``, equal to
    ``native/prep.pack_block_v2``'s and host/wire.pack_wire_block's, or None
    for the numpy packer. floors = (u0_pin, k2p_floor, kp_floor) from the
    engine's shape registry, or floors_for((Sp, U)) looks them up."""
    lib = _lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(np.asarray(cell_ids, dtype=np.int64))
    B = len(ids)
    cell_ptr, obs_snp = csr.cell_ptr, csr.obs_snp
    obs_al, obs_bq = csr.obs_allele, csr.obs_bq  # argtypes check them
    cw, dw = cfg.code_w, cfg.delta_w
    dims = np.zeros(4 + len(CANDS), dtype=np.int64)
    lib.dmx_pack3_dims(cell_ptr, obs_snp, obs_al, ids, B, (1 << dw) - 1,
                       CANDS, len(CANDS), dims)
    smax, umax, kmax, flags = (int(x) for x in dims[:4])
    tails_max = dict(zip(CANDS.tolist(), dims[4:].tolist()))

    pad_slots_to = max(pad_slots_to, 128)
    pad_cells_to = -(-max(pad_cells_to, 32) // 32) * 32
    Sp = max(pad_slots_to, -(-max(smax, 1) // pad_slots_to) * pad_slots_to)
    Bp = max(pad_cells_to, -(-B // pad_cells_to) * pad_cells_to)
    U = 1 << max(umax - 1, 0).bit_length()
    # unsorted; u16 fix and tail positions cannot address the slots; a
    # slot deeper than the candidates, whose tails dims did not count
    if flags & 1 or Sp > 0xFFFF or U > int(CANDS[-1]):
        lib.dmx_pack3_fallback()
        return None

    if floors is None and floors_for is not None:
        floors = floors_for((Sp, U))
    u0_pin, k2p_floor, kp_floor = floors if floors else (None, 16, 8)
    if u0_pin is not None:
        U0 = min(u0_pin, U)
    elif not cfg.adaptive:
        U0 = min(cfg.u_cap, U)
    else:  # host/wire._choose_u0's cost model on the dims statistics
        U0, best = U, Sp * U * cw / 8.0
        for c in CANDS[CANDS < U].tolist():
            cost = (Sp * c * cw / 8.0 + size_bucket(tails_max[c], 16)
                    * (_tail_width(Sp, U, c) / 8.0 + cw / 8.0))
            if cost < best:
                U0, best = c, cost
    if U == U0:
        K2p, tw = 0, 16
    else:
        tw = _tail_width(Sp, U, U0)
        K2p = size_bucket(max(tails_max.get(U0, 0), k2p_floor, 1), 16)
    Kp = size_bucket(max(kmax, kp_floor, 1), 8)

    W = (Sp * U0 * cw // 8 + K2p * (tw // 8) + K2p * cw // 8
         + Sp * dw // 8 + 4 + Kp * 6) // 4
    wire = np.empty((Bp, W), dtype=np.int32)
    if lib.dmx_pack3_fill(cell_ptr, obs_snp, obs_al, obs_bq, ids, B,
                          cap_bq, cfg.code_lut(), cfg.n_real, cw, dw,
                          Sp, U, U0, K2p, Kp, tw, Bp, wire, W):
        lib.dmx_pack3_fallback()  # U0 < 1: no dense lane to mark
        return None
    return wire, ("w2", Sp, U, U0, K2p, Kp, cw, dw, cfg.n_real, tw)


def counts():
    """(blocks packed by dmx_pack3_fill, blocks handed to the numpy packer)
    since the library was loaded, or None without the library."""
    lib = _lib()
    if lib is None:
        return None
    calls, fallbacks = C.c_int64(), C.c_int64()
    lib.dmx_pack_counts(C.byref(calls), C.byref(fallbacks))
    return calls.value, fallbacks.value
