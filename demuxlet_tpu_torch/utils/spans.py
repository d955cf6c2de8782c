"""Named host spans of the port's job, one mechanism for the engine's
accounting and the profiler's timeline.

``span(name, acct)`` adds its wall seconds (``time.perf_counter``) to
``acct[name]`` when ``acct`` is given (the engine's ``phase_s``) and,
while a torch profiler runs, is a profiler range named ``demux.<name>``:
an accounting entry and its range share their boundaries. It is a
context manager and, around a whole function, a decorator.

With no profiler running a span costs one flag read and two clock reads
(and a lock around the accounting); no range is entered then. The flag is
``torch.autograd.profiler._is_profiler_enabled``, which every thread
reads while a profiler runs. A profiler keeps the ranges of threads other
than the one that started it (the engine's prefetch pool) only when built
with ``profile_all_threads`` (``profiler_config``).

The range is torch's C++ ``RecordFunctionFast`` (exported as a
``cpu_op`` event), which agrees with its accounting to ~15 us, on the
prefetch threads too.
"""

from __future__ import annotations

import functools
import threading
from time import perf_counter

import torch.autograd.profiler as _profiler
from torch._C._profiler import _ExperimentalConfig
from torch._C._profiler import _RecordFunctionFast as _RANGE

PREFIX = "demux."
_LOCK = threading.Lock()  # the prefetch pool's spans share one acct


class span:
    """A named span: ``with span("setup", eng.phase_s): ...`` or
    ``@span("cell_stats")``. acct None: on the profiler's timeline only."""

    def __init__(self, name: str, acct: dict | None = None):
        self.name, self.acct = name, acct

    def __enter__(self):
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _RANGE(PREFIX + self.name)
            self._range.__enter__()
        # the clock is read inside the range: the accounting leaves out
        # the range's own cost
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        dt = perf_counter() - self._t0
        if self._range is not None:  # closed before any wait on the lock
            self._range.__exit__(*exc)
        if self.acct is not None:
            with _LOCK:
                self.acct[self.name] = self.acct.get(self.name, 0.0) + dt
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(self.name, self.acct):
                return fn(*args, **kwargs)

        return spanned


def profiler_config():
    """The ``experimental_config`` that makes a torch profiler record every
    thread's ranges (``profile_all_threads``)."""
    return _ExperimentalConfig(profile_all_threads=True)
