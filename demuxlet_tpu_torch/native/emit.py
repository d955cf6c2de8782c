"""The native renderer's output into a text file-like."""

from __future__ import annotations

import ctypes as C


def emit(fh, out, n: int) -> None:
    """Write the ``n`` UTF-8 bytes at the C pointer ``out`` to ``fh``,
    decoded straight from the C buffer, with no bytes copy of the whole
    output first: a 64-donor job's .single or .sing2 is ~100 MB."""
    if n:
        addr = C.cast(out, C.c_void_p).value
        fh.write(str((C.c_char * n).from_address(addr), "utf-8"))
