#!/usr/bin/env python3
"""Times the exact pair kernels K3' (csrc/pair_exact.cu) and K7'
(csrc/pair_tiled_exact.cu) of several source trees side by side on one
CUDA card, at the shapes of ``chip_smoke.py``'s phases 6 and 9 and at the
engine's deepest slot pad (S = 4096).

Each variant is a csrc directory and optional -D macros; every variant's
library is built with nvcc (``kernels/build.py``, in parallel) and called
through its C entry point, so variants with the same entry points compare
on the same inputs in one process. Per shape: each variant's max absolute
error against the plain PyTorch version (limit 1e-9), whether two launches
give identical bits, and its median ms over CUDA-event timed launches,
taken in turns (first to last, then last to first; both medians printed).
One JSON line per (shape, variant), ptxas's report per variant, then the
card's name and power limit.

Usage: python3 chip_steps.py [LABEL=DIR[:MACRO,MACRO...] ...]
(no argument: this checkout's csrc alone). Earlier steps are other source
trees (``git archive <commit> demuxlet_tpu_torch/csrc`` unpacked under
``build/``). A variant built with a DMX_PROBE macro (csrc/stage.cuh:
staging alone, or compute alone) is timed and its error printed, but not
held to the limit.
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

KERNELS = ("pair_exact", "pair_tiled_exact")
# (name, kernel, B, S, V, grid)
SHAPES = (
    ("k3_main", "pair_exact", 2048, 1024, 8, cs.GRID),
    ("k3_deep", "pair_exact", 2048, 4096, 8, cs.GRID),
    ("k7_main", "pair_tiled_exact", 2048, 1024, 32, [0.0, 0.5]),
    ("k7_a5", "pair_tiled_exact", 2048, 1024, 32, cs.GRID),
    ("k7_deep", "pair_tiled_exact", 2048, 4096, 32, [0.0, 0.5]),
)


def parse_variants(argv):
    from demuxlet_tpu_torch.kernels import build as kbuild

    if not argv:
        return [("this", kbuild.CSRC, ())]
    out = []
    for arg in argv:
        label, _, spec = arg.partition("=")
        path, _, macros = spec.partition(":")
        out.append((label, os.path.abspath(path),
                    tuple(m for m in macros.split(",") if m)))
    return out


def load_all(variants):
    """{(label, kernel): (CDLL, library path)}, built in parallel."""
    from demuxlet_tpu_torch.kernels import build as kbuild

    jobs = [(v, k) for v in variants for k in KERNELS]
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        paths = list(pool.map(
            lambda vk: kbuild.build(vk[1], vk[0][1], vk[0][2]), jobs))
    libs = {}
    P, I = ctypes.c_void_p, ctypes.c_int
    for ((label, _, _), kernel), path in zip(jobs, paths):
        lib = ctypes.CDLL(path)
        if kernel == "pair_exact":
            # the staged K3' takes C (t's rows) after A; PR 4's did not
            lib.dmx_pair_exact.argtypes = [P] * 8 + [I] * (
                7 if hasattr(lib, "dmx_pair_exact_smem") else 6) + [P]
        else:
            lib.dmx_pair_tiled_exact.argtypes = [P] * 6 + [I] * 6 + [P]
        libs[label, kernel] = (lib, path)
    return libs


def k3_call(lib, t, g, gl, V, A, a0_sep, sym_a, exp_dev):
    C, B, S = t.shape
    kw = dict(dtype=torch.float64, device=t.device)
    outs = (torch.empty((B, V * V * A), **kw), torch.empty((B, A), **kw),
            torch.empty((B, V), **kw), torch.empty((B,), **kw))

    shape = (B, S, V, A, C) if hasattr(lib, "dmx_pair_exact_smem") else (
        B, S, V, A)

    def run():
        rc = lib.dmx_pair_exact(
            t.data_ptr(), g.data_ptr(), gl.data_ptr(), exp_dev.data_ptr(),
            *(o.data_ptr() for o in outs), *shape, int(a0_sep), sym_a,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"dmx_pair_exact returned {rc}")
        return outs
    return run


def k7_call(lib, t, g, V, A, plan, exp_dev, items, alist):
    C, B, S = t.shape
    out = torch.zeros((B, V, V, A), dtype=torch.float64, device=t.device)

    def run():
        rc = lib.dmx_pair_tiled_exact(
            t.data_ptr(), g.data_ptr(), exp_dev.data_ptr(), items.data_ptr(),
            alist.data_ptr(), out.data_ptr(), B, S, V, A, len(plan.items),
            plan.tile, torch.cuda.current_stream().cuda_stream)
        if rc:
            cs.fail(f"dmx_pair_tiled_exact returned {rc}")
        return (out,)
    return run


def main(argv) -> int:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs a CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.front_exact import front_exact
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain

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
        A = len(grid)
        a0_sep, sym_a = grid[0] == 0.0, grid.index(0.5)
        tab, codes, msk, g = cs.exact_inputs(rng, B, S, grid, dev, V)
        t, gl = front_exact(codes, tab.lut, msk, tab.cmask, tab.gsel)
        del codes, msk
        exp_dev = kbuild.int_table(dev, tab.expand)
        runs = {}
        if kernel == "pair_exact":
            want = pair_exact_plain(t, g, gl, V, A, a0_sep, sym_a,
                                    tab.expand)
            for label, _, _ in variants:
                runs[label] = k3_call(libs[label, kernel][0], t, g, gl, V, A,
                                      a0_sep, sym_a, exp_dev)
            want = tuple(w.reshape(w.shape[0], -1) for w in want)
        else:
            plan = PT.plan_tiles(V, A, a0_sep, sym_a)
            want = (PT.pair_tiled_plain(t, g, V, A, plan, tab.expand),)
            items = kbuild.int_table(dev, [v for it in plan.items
                                           for v in it])
            alist = kbuild.int_table(dev, plan.alist)
            for label, _, _ in variants:
                runs[label] = k7_call(libs[label, kernel][0], t, g, V, A,
                                      plan, exp_dev, items, alist)
        res = {}
        for label, run in runs.items():
            first = [x.clone() for x in run()]
            again = run()
            torch.cuda.synchronize()
            err = max(float((x.reshape(w.shape) - w).abs().max())
                      for x, w in zip(first, want))
            same = all(torch.equal(x, y) for x, y in zip(first, again))
            res[label] = dict(max_abs_err=err, relaunch_bit_equal=same,
                              ms=[])
        order = list(runs) + list(runs)[::-1]
        for label in order:
            res[label]["ms"].append(cs.median_ms(runs[label], n=10))
        for label, _, macros in variants:
            r = res[label]
            probe = any(m.startswith("DMX_PROBE") for m in macros)
            ok = probe or np.isfinite(r["max_abs_err"]) and \
                r["max_abs_err"] <= cs.EXACT_TOL and r["relaunch_bit_equal"]
            print(json.dumps({"shape": name, "kernel": kernel, "B": B, "S": S,
                              "V": V, "A": A, "variant": label, "ok": bool(ok),
                              **r, "card": card}), flush=True)
            if not ok:
                cs.fail(f"{label} {name}: {r}")
        del tab, g, t, gl, want, runs
        torch.cuda.empty_cache()
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
