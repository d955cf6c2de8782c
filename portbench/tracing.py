"""Reading a torch.profiler trace of the measured window.

Device time comes from the trace's kernel, memcpy and memset events: busy
seconds are the union of their intervals. Each kernel's seconds are summed
by name; the breakdown names a device operation by the port's kernel, else by
the aten op that launched it. An idle gap between device intervals is cut
by what the calling thread was doing over it: the innermost of the
benchmark's own spans (``portbench.*``) and the aten op then running, if
any; each piece adds its seconds to that name.
"""

from __future__ import annotations

import bisect
import json
import re

SPAN_PREFIX = "portbench."
# the port's own kernels (csrc/*.cu), named by themselves in the breakdown
OWN_KERNELS = ("front_exact_kernel", "pair_exact_kernel",
               "pair_tiled_exact_kernel", "extras_exact_kernel",
               "pair_fast_kernel", "pair_tiled_fast_kernel",
               "extras_fast_kernel")


def _intervals(events):
    """Merged (start, end) microsecond intervals of ``events``, sorted."""
    out = []
    for e in sorted(events, key=lambda e: e["ts"]):
        a, b = e["ts"], e["ts"] + e["dur"]
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _segments(events):
    """The timeline of one thread's nested ``events`` as sorted,
    non-overlapping (start, end, name) pieces, each named by the innermost
    event open over it; time under no event is left out."""
    bounds = sorted({x for e in events for x in (e["ts"], e["ts"] + e["dur"])})
    starts = sorted(events, key=lambda e: (e["ts"], -e["dur"]))
    out, stack, i = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(starts) and starts[i]["ts"] <= a:
            stack.append(starts[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= a:
            stack.pop()
        # an event that ended under a later sibling leaves the stack late
        live = [e for e in stack if e["ts"] + e["dur"] > a]
        if live:
            out.append((a, b, live[-1]["name"]))
    return out


def _name_at(segs, starts, a, b):
    """[(piece start, piece end, name or None)] of (a, b) cut by ``segs``
    (``starts``: their start times)."""
    out, t = [], a
    k = max(bisect.bisect_right(starts, a) - 1, 0)
    while t < b:
        while k < len(segs) and segs[k][1] <= t:
            k += 1
        if k < len(segs) and segs[k][0] <= t:
            end = min(segs[k][1], b)
            out.append((t, end, segs[k][2]))
        else:
            end = min(segs[k][0], b) if k < len(segs) else b
            out.append((t, end, None))
        t = end
    return out


def summarize(path, top=10):
    """dict(busy_s, kernel_s {name: s}, device_ops [[name, s]],
    idle_gaps [[name, s]]) of the exported trace at ``path``; the idle gaps
    are those inside the benchmark's ``portbench.window`` span."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset") and "dur" in e]
    ops = [e for e in ev if e.get("cat") == "cpu_op" and "dur" in e]
    op_of = {e["args"].get("External id"): e["name"] for e in ops
             if "args" in e}
    spans = [e for e in ev if e.get("name", "").startswith(SPAN_PREFIX)
             and "dur" in e]
    merged = _intervals(dev)
    busy_us = sum(b - a for a, b in merged)
    kernel_s, by_op = {}, {}
    for e in dev:
        s = e["dur"] / 1e6
        if e["cat"] == "kernel":
            kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + s
            name = op_of.get(e.get("args", {}).get("External id"))
            own = re.search(r"\w+_kernel(<[^()]*>)?", e["name"])
            if own and own.group(0).split("<")[0] in OWN_KERNELS:
                name = own.group(0)
            elif name is None:
                name = e["name"][:80]
        else:
            name = e["name"]
        by_op[name] = by_op.get(name, 0.0) + s
    gaps = {}
    window = [e for e in spans if e["name"] == SPAN_PREFIX + "window"]
    if window:
        tid = window[0]["tid"]
        lo, hi = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
        mine = [e for e in spans if e["tid"] == tid]
        my_ops = [e for e in ops if e["tid"] == tid]
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        found = [(max(a, lo), min(b, hi))
                 for a, b in zip(edges[0::2], edges[1::2])]
        found = [(a, b) for a, b in found if b > a]
        spans_t, ops_t = _segments(mine), _segments(my_ops)
        spans_s, ops_s = [x[0] for x in spans_t], [x[0] for x in ops_t]
        for a, b in found:
            for a2, b2, span in _name_at(spans_t, spans_s, a, b):
                for a3, b3, op in _name_at(ops_t, ops_s, a2, b2):
                    name = (span[len(SPAN_PREFIX):] if span else "outside")
                    name += "/" + (op or "python")
                    gaps[name] = gaps.get(name, 0.0) + (b3 - a3) / 1e6

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:top]]

    return dict(busy_s=busy_us / 1e6, kernel_s=kernel_s,
                device_ops=ranked(by_op), idle_gaps=ranked(gaps))
