#!/usr/bin/env python3
"""Times the pair kernels K3' (csrc/pair_exact.cu), K7'
(csrc/pair_tiled_exact.cu), K1 (csrc/pair_fast.cu) and K5'
(csrc/pair_tiled_fast.cu), the exact front K2' (csrc/front_exact.cu) and
the O(V) channels K6' (csrc/extras_exact.cu, beside K7') and K4'
(csrc/extras_fast.cu, beside K5') of several source trees side by side on
one CUDA card, at the shapes of ``chip_smoke.py``'s phases 3, 6, 9 and 12,
at the engine's deepest slot pad (S = 4096) and, for K2', at the engine's
lane profile (``chip_smoke.lane_profile_inputs``: U = 64 lanes as wire-v2
parts; U, U0 and K2p printed).

Each variant is a csrc directory, optional -D macros and optionally the
kernels it is built for (default: all seven); every variant's library is
built with nvcc (``kernels/build.py``, in parallel) and called through its
C entry point, so variants with the same entry points compare on the same
inputs in one process. K2' before the wire-v2 parts (no
``dmx_front_exact_smem``) takes the full lanes, rebuilt once from the same
parts. Per shape: each variant's error against the plain PyTorch version
(K2': relative, limit 1e-12; the other exact kernels: absolute, limit
1e-9; fast kernels: relative with scale max(1, |x|), limit 2e-5), whether
two launches give identical bits, whether its outputs equal the first
variant's bit for bit (required of every kernel but K4', whose
accumulation the steps change: a change that leaves a kernel's arithmetic
as it was shows it here), and its median ms over CUDA-event timed
launches, taken in turns (first to last, then last to first; both medians
printed). One JSON line per (shape, variant), ptxas's report per variant,
then the card's name and power limit.

Usage: python3 chip_steps.py [LABEL=DIR[:MACRO,MACRO...][@KERNEL,...] ...]
(no argument: this checkout's csrc alone). Earlier steps are other source
trees (``git archive <commit> demuxlet_tpu_torch/csrc`` unpacked under
``build/``). A variant built with a DMX_PROBE macro (csrc/stage.cuh:
staging alone, or compute alone) is timed and its error printed, but not
held to the limits.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs

KERNELS = ("pair_exact", "pair_tiled_exact", "pair_fast", "pair_tiled_fast",
           "front_exact", "extras_exact", "extras_fast")
EXACT = ("pair_exact", "pair_tiled_exact", "front_exact", "extras_exact")
# held bit-equal to the first variant
BIT_EQUAL = ("pair_exact", "pair_tiled_exact", "pair_fast", "pair_tiled_fast",
             "front_exact", "extras_exact")
# (name, kernel, B, S, V, grid)
SHAPES = (
    ("k3_main", "pair_exact", 2048, 1024, 8, cs.GRID),
    ("k3_deep", "pair_exact", 2048, 4096, 8, cs.GRID),
    ("k7_main", "pair_tiled_exact", 2048, 1024, 32, [0.0, 0.5]),
    ("k7_a5", "pair_tiled_exact", 2048, 1024, 32, cs.GRID),
    ("k7_deep", "pair_tiled_exact", 2048, 4096, 32, [0.0, 0.5]),
    ("k1_main", "pair_fast", 2048, 1024, 8, cs.GRID),
    ("k1_deep", "pair_fast", 2048, 4096, 8, cs.GRID),
    ("k5_main", "pair_tiled_fast", 2048, 1024, 32, [0.0, 0.5]),
    ("k5_a5", "pair_tiled_fast", 2048, 1024, 32, cs.GRID),
    ("k5_deep", "pair_tiled_fast", 2048, 4096, 32, [0.0, 0.5]),
    ("k2_main", "front_exact", 2048, 1024, 8, cs.GRID),
    ("k2_deep", "front_exact", 2048, 4096, 8, cs.GRID),
    ("k6_main", "extras_exact", 2048, 1024, 32, [0.0, 0.5]),
    ("k6_a5", "extras_exact", 2048, 1024, 32, cs.GRID),
    ("k6_deep", "extras_exact", 2048, 4096, 32, [0.0, 0.5]),
    ("k4_main", "extras_fast", 2048, 1024, 32, [0.0, 0.5]),
    ("k4_a5", "extras_fast", 2048, 1024, 32, cs.GRID),
    ("k4_deep", "extras_fast", 2048, 4096, 32, [0.0, 0.5]),
)


def parse_variants(argv):
    """[(label, csrc dir, macros, kernels)] from the command line."""
    from demuxlet_tpu_torch.kernels import build as kbuild

    if not argv:
        return [("this", kbuild.CSRC, (), KERNELS)]
    out = []
    for arg in argv:
        label, _, spec = arg.partition("=")
        spec, _, only = spec.partition("@")
        path, _, macros = spec.partition(":")
        kernels = tuple(k for k in only.split(",") if k) or KERNELS
        if not set(kernels) <= set(KERNELS):
            cs.fail(f"unknown kernels in {arg}")
        out.append((label, os.path.abspath(path),
                    tuple(m for m in macros.split(",") if m), kernels))
    return out


def load_all(variants):
    """{(label, kernel): (CDLL, library path)}, built in parallel."""
    from demuxlet_tpu_torch.kernels import build as kbuild

    jobs = [(v, k) for v in variants for k in v[3]]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        paths = list(pool.map(
            lambda vk: kbuild.build(vk[1], vk[0][1], vk[0][2]), jobs))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for ((label, _, _, _), kernel), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        fn = getattr(lib, "dmx_" + kernel)
        if kernel == "pair_exact":
            # the staged K3' takes C (t's rows) after A; PR 4's did not
            fn.argtypes = [P] * 8 + [I] * (
                7 if hasattr(lib, "dmx_pair_exact_smem") else 6) + [P]
        elif kernel == "pair_fast":
            fn.argtypes = [P] * 5 + [I] * 6 + [P]
        elif kernel == "front_exact":
            # the wire-v2 parts, or (an older tree) the full lanes
            fn.argtypes = [P] * 8 + [I] * 12 + [P] if hasattr(
                lib, "dmx_front_exact_smem") else [P] * 6 + [
                    ctypes.c_longlong] + [I] * 7 + [P]
        elif kernel in ("extras_exact", "extras_fast"):
            fn.argtypes = [P] * 5 + [I] * 5 + [P]
        else:
            fn.argtypes = [P] * 6 + [I] * 6 + [P]
        libs[label, kernel] = (lib, path)
    return libs


def _check(name, rc):
    if rc:
        cs.fail(f"{name} returned {rc}")


def k3_call(lib, t, g, gl, V, A, a0_sep, sym_a, exp_dev):
    C, B, S = t.shape
    kw = dict(dtype=torch.float64, device=t.device)
    outs = (torch.empty((B, V * V * A), **kw), torch.empty((B, A), **kw),
            torch.empty((B, V), **kw), torch.empty((B,), **kw))

    shape = (B, S, V, A, C) if hasattr(lib, "dmx_pair_exact_smem") else (
        B, S, V, A)

    def run():
        _check("dmx_pair_exact", lib.dmx_pair_exact(
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            *(o.data_ptr() for o in outs), *shape, int(a0_sep), sym_a,
            torch.cuda.current_stream().cuda_stream))
        return outs
    return run


def k1_call(lib, t, g, V, A, a0_sep, sym_a, exp_dev):
    _, B, S = t.shape
    kw = dict(dtype=torch.float32, device=t.device)
    outs = (torch.empty((B, V * V * A), **kw), torch.empty((B, A), **kw))

    def run():
        _check("dmx_pair_fast", lib.dmx_pair_fast(
            t.data_ptr(), g.data_ptr(), exp_dev.data_ptr(),
            *(o.data_ptr() for o in outs), B, S, V, A, int(a0_sep), sym_a,
            torch.cuda.current_stream().cuda_stream))
        return outs
    return run


def k2_call(lib, tab, dense, tail, n_deep, msk, full):
    """K2' on the wire-v2 parts, or (a library without
    ``dmx_front_exact_smem``) on the full lanes rebuilt from them."""
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.kernels import front_exact as k2

    B, S, U0 = dense.shape
    R, C = tab.lut.shape
    kw = dict(dtype=torch.float64, device=dense.device)
    outs = (torch.empty((C, B, S), **kw), torch.empty((3, B, S), **kw))
    cm = kbuild.int_table(dense.device, [bool(c) for c in tab.cmask])
    chans = (R, C, *map(int, tab.gsel), int(R * C * 8 <= k2.SMEM_MAX))
    K2p = tail[0].shape[1] if tail is not None else 0
    parts = hasattr(lib, "dmx_front_exact_smem")

    def run():
        # the pointers are taken here, so the closure keeps every input alive
        ptrs = (tab.lut.data_ptr(), msk.data_ptr(), cm.data_ptr(),
                outs[0].data_ptr(), outs[1].data_ptr())
        if parts:
            args = (dense.data_ptr(), *(x.data_ptr() if K2p else None
                                        for x in tail or (None, None)),
                    *ptrs, B, S, U0, K2p, n_deep if K2p else 0, *chans,
                    int(K2p * 8 <= k2.TAIL_SMEM_MAX))
        else:
            args = (full.data_ptr(), *ptrs, B * S, full.shape[2], *chans)
        _check("dmx_front_exact", lib.dmx_front_exact(
            *args, torch.cuda.current_stream().cuda_stream))
        return outs
    return run


def k6_call(lib, t, g, gl, V, A, a0_sep, exp_dev):
    from demuxlet_tpu_torch.ops.pair_tiled import extras_keys

    _, B, S = t.shape
    out = torch.empty((B, len(extras_keys(V, A, a0_sep))),
                      dtype=torch.float64, device=t.device)

    def run():
        _check("dmx_extras_exact", lib.dmx_extras_exact(
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            out.data_ptr(), B, S, V, A, int(a0_sep),
            torch.cuda.current_stream().cuda_stream))
        return (out,)
    return run


def k4_call(lib, t, g, g0, V, A, a0_sep, exp_dev):
    from demuxlet_tpu_torch.ops.pair_tiled import extras_keys

    _, B, S = t.shape
    out = torch.empty((B, len(extras_keys(V, A, a0_sep, singlets=False))),
                      dtype=torch.float32, device=t.device)

    def run():
        _check("dmx_extras_fast", lib.dmx_extras_fast(
            t.data_ptr(), g.data_ptr(), g0.data_ptr(), exp_dev.data_ptr(),
            out.data_ptr(), B, S, V, A, int(a0_sep),
            torch.cuda.current_stream().cuda_stream))
        return (out,)
    return run


def tiled_call(fn, t, g, V, A, plan, exp_dev, items, alist):
    """K7' or K5' (fn: the library's entry point) on the plan's items."""
    C, B, S = t.shape
    out = torch.zeros((B, V, V, A), dtype=t.dtype, device=t.device)

    def run():
        _check(fn.__name__, fn(
            t.data_ptr(), g.data_ptr(), exp_dev.data_ptr(), items.data_ptr(),
            alist.data_ptr(), out.data_ptr(), B, S, V, A, len(plan.items),
            plan.tile, torch.cuda.current_stream().cuda_stream))
        return (out,)
    return run


def shape_runs(kernel, B, S, V, grid, dev, rng, variants, libs):
    """The plain version's outputs, per variant that builds the kernel a
    function that launches it once on this shape's inputs, and the
    shape's lane profile (K2')."""
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.front_exact import (
        front_exact,
        front_exact_plain,
    )
    from demuxlet_tpu_torch.ops.pair import pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain
    from demuxlet_tpu_torch.ops.wire import rebuild_lanes

    A = len(grid)
    a0_sep, sym_a = grid[0] == 0.0, grid.index(0.5)
    fast = kernel not in EXACT
    labels = [v[0] for v in variants if kernel in v[3]]
    lib = {label: libs[label, kernel][0] for label in labels}
    if kernel == "front_exact":
        tab, dense, tail, n_deep, msk, _, info = cs.lane_profile_inputs(
            rng, B, S, dev, grid, V)
        want = front_exact_plain(dense, tab.lut, msk, tab.cmask, tab.gsel,
                                 tail, n_deep)
        full = dense if tail is None else rebuild_lanes(
            dense, *tail, n_deep, tab.lut.shape[0] - 1)
        runs = {k: k2_call(lib[k], tab, dense, tail, n_deep, msk, full)
                for k in labels}
        return want, runs, info
    if fast:
        t, g, g0, expand = cs.pair_inputs(rng, B, S, grid, dev, V)
    else:
        tab, codes, msk, g = cs.exact_inputs(rng, B, S, grid, dev, V)
        t, gl = front_exact(codes, tab.lut, msk, tab.cmask, tab.gsel)
        expand = tab.expand
        del codes, msk
    exp_dev = kbuild.int_table(dev, expand)
    if kernel == "pair_exact":
        want = pair_exact_plain(t, g, gl, V, A, a0_sep, sym_a, expand)
        runs = {k: k3_call(lib[k], t, g, gl, V, A, a0_sep, sym_a, exp_dev)
                for k in labels}
    elif kernel == "pair_fast":
        want = pair_llks_plain(t, g, V, A, a0_sep, sym_a, expand)
        runs = {k: k1_call(lib[k], t, g, V, A, a0_sep, sym_a, exp_dev)
                for k in labels}
    elif kernel == "extras_exact":
        want = (PT.extras_plain(t, g, gl, V, A, a0_sep, expand),)
        runs = {k: k6_call(lib[k], t, g, gl, V, A, a0_sep, exp_dev)
                for k in labels}
    elif kernel == "extras_fast":
        want = (PT.extras_fast_plain(t, g, g0, V, A, a0_sep, expand),)
        runs = {k: k4_call(lib[k], t, g, g0, V, A, a0_sep, exp_dev)
                for k in labels}
    else:
        plan = PT.plan_tiles(V, A, a0_sep, sym_a)
        want = (PT.pair_tiled_plain(t, g, V, A, plan, expand),)
        items = kbuild.int_table(dev, [v for it in plan.items for v in it])
        alist = kbuild.int_table(dev, plan.alist)
        runs = {k: tiled_call(getattr(lib[k], "dmx_" + kernel), t, g, V, A,
                              plan, exp_dev, items, alist) for k in labels}
    return tuple(w.reshape(w.shape[0], -1) for w in want), runs, {}


def front_rel_err(x, ref) -> float:
    """K2''s error: relative to |ref| (t and gl are positive)."""
    return float(((x - ref).abs() / ref.abs().clamp(min=1e-300)).max())


def main(argv) -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    variants = parse_variants(argv)
    libs = load_all(variants)
    for (label, kernel), (_, path) in libs.items():
        print(json.dumps({"variant": label, "kernel": kernel,
                          "ptxas": kbuild.ptxas_report(path)}), flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(11)
    for name, kernel, B, S, V, grid in SHAPES:
        if not any(kernel in v[3] for v in variants):
            continue
        want, runs, info = shape_runs(kernel, B, S, V, grid, dev, rng,
                                      variants, libs)
        exact = kernel in EXACT
        err_fn, tol = ((front_rel_err, cs.FRONT_TOL) if kernel == "front_exact"
                       else (cs.abs_err, cs.EXACT_TOL) if exact
                       else (cs.rel_err, cs.TOL))
        res, first = {}, None
        for label, run in runs.items():
            got = [x.clone().reshape(w.shape) for x, w in zip(run(), want)]
            again = run()
            torch.cuda.synchronize()
            err = max(err_fn(x, w) for x, w in zip(got, want))
            first = got if first is None else first
            res[label] = dict(
                max_abs_err=max(cs.abs_err(x, w) for x, w in zip(got, want)),
                max_rel_err=None if err_fn is cs.abs_err else err,
                relaunch_bit_equal=all(
                    torch.equal(x, y.reshape(x.shape))
                    for x, y in zip(got, again)),
                bit_equal_first=all(torch.equal(x, y)
                                    for x, y in zip(got, first)),
                ms=[])
            del got, again
        order = list(runs) + list(runs)[::-1]
        for label in order:
            res[label]["ms"].append(cs.median_ms(runs[label], n=10))
        for label, _, macros, _ in variants:
            if label not in res:
                continue
            r = res[label]
            probe = any(m.startswith("DMX_PROBE") for m in macros)
            err = r["max_abs_err"] if r["max_rel_err"] is None \
                else r["max_rel_err"]
            ok = probe or (np.isfinite(err) and err <= tol
                           and r["relaunch_bit_equal"]
                           and (r["bit_equal_first"]
                                or kernel not in BIT_EQUAL))
            print(json.dumps({"shape": name, "kernel": kernel, "B": B, "S": S,
                              "V": V, "A": len(grid), **info,
                              "variant": label, "ok": bool(ok), **r,
                              "card": card}), flush=True)
            if not ok:
                cs.fail(f"{label} {name}: {r}")
        del want, runs, first
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
