"""A job's barcode order and packed barcodes, built once for both native
renders (``dmx_bc_order``, native/render.cpp).

``write_single`` and ``write_pass2_compact`` (native/render.py) render
the same ``CellStats`` in the same order: ``barcodes(stats, lib)`` builds
the order and the NUL-terminated barcode bytes at the first call (inside
the first render's span ``render.order``), keeps them on ``stats``, and
hands the second call the same arrays. The order is
``CellStats.bc_order()``'s, and the bytes and offsets are
``native/render._concat``'s.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
# the attribute of a CellStats that holds (its barcodes, what they gave)
_MEMO = "_native_barcodes"


def _fn(lib, name, restype, argtypes):
    """``lib``'s export ``name``, bound on a function object of its own
    (none that another thread binds)."""
    fn = lib[name]
    fn.restype, fn.argtypes = restype, argtypes
    return fn


def pack(strs):
    """(bytes, offsets) of ``strs``: each string's UTF-8 and a NUL, and
    each one's start, the total last. One join and one vectorised scan
    for the NULs; a string that holds a NUL itself sends the offsets to
    a count of each string's bytes."""
    off = np.zeros(len(strs) + 1, np.int64)
    if not strs:
        return b"", off
    blob = "\0".join(strs).encode() + b"\0"
    ends = np.flatnonzero(np.frombuffer(blob, np.uint8) == 0) + 1
    if len(ends) != len(strs):
        ends = np.cumsum([len(s.encode()) + 1 for s in strs])
    off[1:] = ends
    return blob, off


def barcodes(stats, lib):
    """(order, bc_concat, bc_off) of ``stats.barcodes`` for ``lib``'s
    renders: built at the first call on ``stats``, the same objects after.
    The order falls back to ``stats.bc_order()`` where ``dmx_bc_order``
    cannot allocate its records."""
    memo = getattr(stats, _MEMO, None)
    if (memo is not None and memo[0] is stats.barcodes
            and len(memo[1][0]) == len(stats.barcodes)):
        return memo[1]
    strs = stats.barcodes
    bc_concat, bc_off = pack(strs)
    order = np.empty(len(strs), np.int64)
    fn = _fn(lib, "dmx_bc_order", C.c_int,
             [C.c_int64, C.c_char_p, _I64P, _I64P])
    if fn(len(strs), bc_concat, bc_off, order) != 0:
        order = np.asarray([i for _, i in stats.bc_order()], np.int64)
    got = (order, bc_concat, bc_off)
    setattr(stats, _MEMO, (strs, got))
    return got


def counts(lib):
    """(orders built, barcodes they sorted) since ``lib`` was loaded."""
    fn = _fn(lib, "dmx_order_counts", None, [C.POINTER(C.c_int64)] * 2)
    calls, n = C.c_int64(), C.c_int64()
    fn(C.byref(calls), C.byref(n))
    return calls.value, n.value
