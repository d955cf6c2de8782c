"""ctypes bindings for the native .sing2/.best renderer (_render.so).

Replaces models/outputs.write_pass2_compact's Python formatting loop on
the production path (~50 us/row -> ~1-2 us/row at 100K cells); falls
back to the Python renderer when the library can't be built/loaded.
Byte parity is pinned by tests/test_native_render.py.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess

import numpy as np

from demuxlet_tpu_torch.native.emit import emit
from demuxlet_tpu_torch.utils.spans import span

_LIB = None
_LOAD_FAILED = False

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "render.cpp")
OUT = os.path.join(HERE, "_render.so")


def build(force: bool = False) -> str:
    if (
        not force
        and os.path.exists(OUT)
        and os.path.getmtime(OUT) >= os.path.getmtime(SRC)
    ):
        return OUT
    # temp + rename: concurrent builders (distributed shards) must never
    # dlopen a half-written .so
    tmp = OUT + ".tmp%d" % os.getpid()
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-o", tmp, SRC],
        check=True,
    )
    os.replace(tmp, OUT)
    return OUT


_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _load():
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    try:
        lib = C.CDLL(build())
    except Exception:
        _LOAD_FAILED = True
        return None
    fn = lib.dmx_render_pass2_compact
    fn.restype = C.c_int
    fn.argtypes = [
        C.c_int64, _I64P,                      # n_order, order
        C.c_char_p, _I64P,                     # bc_concat, bc_off
        C.c_char_p, _I64P,                     # sm_concat, sm_off
        C.c_int64, C.c_int64, _F64P, C.c_double,  # nv, na, grid, prior
        _I64P, _I64P, _I64P, _I64P,            # totl, pass, uniq, nsnp
        _F64P, _F64P, _F64P,                   # max_llk, ssum, dsum
        _F64P, _F64P,                          # sing_col, llk00
        _I64P, _I64P, _I64P,                   # i1, i2, best
        _F64P, _F64P, _F64P, _F64P,            # max2, p12, p10, p20
        C.c_int64, C.c_int64, C.c_int64,       # min_total/uniq/snp
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
    ]
    fn1 = lib.dmx_render_single
    fn1.restype = C.c_int
    fn1.argtypes = [
        C.c_int64, _I64P,                      # n_order, order
        C.c_char_p, _I64P,                     # bc_concat, bc_off
        C.c_char_p, _I64P, C.c_int64,          # sm_concat, sm_off, nv
        _I64P, _I64P, _I64P, _I64P,            # totl, pass, uniq, nsnp
        _F64P, _F64P,                          # llks, llk0s
        C.c_int64, C.c_int64, C.c_int64,       # min_total/uniq/snp
        C.POINTER(C.c_char_p), C.POINTER(C.c_int64),
    ]
    lib.dmx_render_free.restype = None
    lib.dmx_render_free.argtypes = [C.c_char_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _concat(strs):
    """NUL-terminated concatenation + per-entry start offsets."""
    off = np.zeros(len(strs) + 1, np.int64)
    bs = []
    pos = 0
    for i, s in enumerate(strs):
        b = s.encode() + b"\x00"
        bs.append(b)
        pos += len(b)
        off[i + 1] = pos
    return b"".join(bs), off


def write_pass2_compact(
    stats, sample_ids, compact, grid_alpha, doublet_prior,
    wsing2, wbest, min_total=0, min_uniq=0, min_snp=0,
) -> bool:
    """Native render into the two file-likes. Returns False (caller must
    fall back) when the library is unavailable."""
    lib = _load()
    if lib is None:
        return False
    Cc = compact
    with span("render.order"):
        order = np.asarray([i for _, i in stats.bc_order()], np.int64)
    with span("render.pack"):
        bc_concat, bc_off = _concat(stats.barcodes)
        sm_concat, sm_off = _concat(list(sample_ids))
        f64 = lambda a: np.ascontiguousarray(a, np.float64)
        i64 = lambda a: np.ascontiguousarray(a, np.int64)
        out2, len2 = C.c_char_p(), C.c_int64()
        outb, lenb = C.c_char_p(), C.c_int64()
        args = (
            len(order), order, bc_concat, bc_off, sm_concat, sm_off,
            len(sample_ids), len(grid_alpha),
            f64(list(grid_alpha)), float(doublet_prior),
            i64(stats.totl), i64(stats.pass_), i64(stats.uniq), i64(stats.nsnp),
            f64(Cc.max_llk), f64(Cc.sum_single), f64(Cc.sum_double),
            f64(Cc.sing_col), f64(Cc.llk_00),
            i64(Cc.i_sing1), i64(Cc.i_sing2), i64(Cc.best_flat),
            f64(Cc.max_sing2), f64(Cc.pair_llk12), f64(Cc.pair_llk10),
            f64(Cc.pair_llk20),
            int(min_total), int(min_uniq), int(min_snp),
            C.byref(out2), C.byref(len2), C.byref(outb), C.byref(lenb),
        )
    with span("render.native"):
        rc = lib.dmx_render_pass2_compact(*args)
    if rc != 0:
        return False
    try:
        with span("render.emit"):
            emit(wsing2, out2, len2.value)
            emit(wbest, outb, lenb.value)
    finally:
        lib.dmx_render_free(out2)
        lib.dmx_render_free(outb)
    return True


def write_single(
    stats, sample_ids, llks, llk0s, fh,
    min_total=0, min_uniq=0, min_snp=0,
) -> bool:
    """Native .single body render. False -> caller falls back."""
    lib = _load()
    if lib is None:
        return False
    with span("render.order"):
        order = np.asarray([i for _, i in stats.bc_order()], np.int64)
    with span("render.pack"):
        bc_concat, bc_off = _concat(stats.barcodes)
        sm_concat, sm_off = _concat(list(sample_ids))
        f64 = lambda a: np.ascontiguousarray(a, np.float64)
        i64 = lambda a: np.ascontiguousarray(a, np.int64)
        out, ln = C.c_char_p(), C.c_int64()
        args = (
            len(order), order, bc_concat, bc_off, sm_concat, sm_off,
            len(sample_ids),
            i64(stats.totl), i64(stats.pass_), i64(stats.uniq), i64(stats.nsnp),
            f64(llks), f64(llk0s),
            int(min_total), int(min_uniq), int(min_snp),
            C.byref(out), C.byref(ln),
        )
    with span("render.native"):
        rc = lib.dmx_render_single(*args)
    if rc != 0:
        return False
    try:
        with span("render.emit"):
            emit(fh, out, ln.value)
    finally:
        lib.dmx_render_free(out)
    return True
