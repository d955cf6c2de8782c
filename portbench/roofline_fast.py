"""Work counts and roofline shares of the fast route's pair search, beside
``roofline.py``'s for the exact route.

The fast route (``--mode fast``) runs its pair search in f32: K1
(``csrc/pair_fast.cu``), or on pools with V*V*A > 384 K5'
(``csrc/pair_tiled_fast.cu``) with K4' (``csrc/extras_fast.cu``). Torch
computes its singlet term outside those kernels, so their work is
``roofline.pair_work`` without the singlet channels. Its least time counts
at the card's f32 peak (``roofline.PEAK_OPS["f32"]``) and the memory rate.
As in ``roofline.py``, the work is counted from the library's own sizes,
never from the engine's padded slots or blocks, and the bytes are the
stage's inputs read once: a 4-byte SNP id a covered slot and the f32
genotype table (3 posteriors a SNP and donor).
"""

from __future__ import annotations

from portbench import roofline

F32 = 4
# each kernel whose name contains one of these: K1, K5', K4'
PAIR_KERNELS = ("pair_fast_kernel", "pair_tiled_fast_kernel",
                "extras_fast_kernel")


def pair_work_of(sizes, cfg):
    """(ops, bytes) of the fast pair search without the singlet term:
    ``roofline.pair_work``'s channels and U rows a slot, one log a channel
    a cell; bytes: a SNP id a slot and the f32 genotype table in."""
    V, grid = cfg["donors"], cfg["grid_alpha"]
    A = len(grid)
    sym_a = grid.index(0.5) if 0.5 in grid else None
    chans, rows = roofline.pair_work(V, A, grid[0] == 0.0, sym_a, False)
    ops = sizes["slots"] * (chans * roofline.CHANNEL_OPS
                            + rows * roofline.ROW_OPS) \
        + sizes["cells"] * chans * roofline.LOG_OPS
    nbytes = 4 * sizes["slots"] + F32 * cfg["snps"] * 3 * V
    return ops, nbytes


def window_least_s(ctx):
    """The fast pair search's least seconds over every job of the traced
    window, at the f32 peak: ``pair_work_of`` of each job's library,
    summed."""
    per_lib = [roofline.least_s(*pair_work_of(sizes, ctx["config"]), "f32")
               for sizes in ctx["sizes"]]
    return sum(per_lib[job["lib"]] for job in ctx["jobs"])


def pair_roofline_pct(ctx):
    """The fast pair search's share of its roofline in %, or None without
    a trace, jobs or any of its kernels in the trace: its least seconds
    over the device seconds of ``PAIR_KERNELS``."""
    trace = ctx.get("trace")
    if trace is None or not ctx["jobs"]:
        return None
    dev_s = sum(s for name, s in trace["kernel_s"].items()
                if any(k in name for k in PAIR_KERNELS))
    if dev_s <= 0.0:
        return None
    return 100.0 * window_least_s(ctx) / dev_s
