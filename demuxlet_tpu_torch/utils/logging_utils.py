"""Timestamped stderr notices matching the reference's logging style.

Reference: Error.cpp:71-86 — `notice()` prints
"NOTICE [YYYY/MM/DD hh:mm:ss] - <message>" to stderr; `warning()` and
`error()` similar, with error() raising (pexception -> std::terminate in the
reference; here a DemuxError).
"""

from __future__ import annotations

import sys
import time


class DemuxError(RuntimeError):
    pass


def _stamp() -> str:
    return time.strftime("%Y/%m/%d %H:%M:%S")


def notice(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    sys.stderr.write(f"NOTICE [{_stamp()}] - {msg}\n")
    sys.stderr.flush()


def warning(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    sys.stderr.write(f"WARNING [{_stamp()}] - {msg}\n")
    sys.stderr.flush()


def error(fmt: str, *args) -> None:
    msg = fmt % args if args else fmt
    sys.stderr.write(f"FATAL ERROR - \n{msg}\n")
    sys.stderr.flush()
    raise DemuxError(msg)
