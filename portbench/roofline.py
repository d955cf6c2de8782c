"""Peaks and work counts of the port's device stages.

A stage's least time is the larger of its operations over the card's peak
rate for their type and its bytes over the memory rate; its roofline share is
that least time over the device time its kernels took. NVIDIA H100 SXM data
sheet (the rates assume the full 700 W power limit): 34 TFLOP/s f64 outside
the tensor cores (none of the port's kernels can use them), 3.35 TB/s HBM3.
One log or exp counts as 20 operations of its type, an FMA as 2.

The work is counted from the library's own sizes (cells, covered (cell, SNP)
slots, observations, donors V, alphas A) and never from the engine's padded
slot axis, its blocks or a kernel's layout, so the count stays the same
whatever blocking or kernel does the work. Bytes are the job's inputs and
outputs alone, each counted once, in the stage that needs it first: an
observation's code byte and the slots' offsets (the front), the slots' SNP
ids and the genotype table (the pair search), the compact rows the job
returns (the decision pass). What one stage hands the next (the front's
factors, the pair search's LLKs) is a kernel's layout and is not counted,
so a kernel that merges two stages meets the same count. A pair or singlet
channel's sum over slots of log(inner) needs no log per slot: its inner
values multiply into a running product and take one log per channel per
cell.
"""

from __future__ import annotations

from portbench.reference import factor_tables

PEAK_OPS = {"f64": 34e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
LOG_OPS = 20
CHANNEL_OPS = 7  # per slot: a 3-term dot (3 FMAs) and one multiply
ROW_OPS = 18  # one row of U = g_j . t_a: 9 FMAs
F64 = 8


def least_s(ops, nbytes, kind="f64"):
    """Seconds: the larger of ops over the peak rate of their type and bytes
    over the memory rate."""
    return max(ops / PEAK_OPS[kind], nbytes / HBM_BYTES_PER_S)


def pair_work(V, A, a0_sep, sym_a, singlets):
    """Per slot, the (channels, U rows) a pair search needs: the separable
    alpha == 0 plane as 2V factors and the background pair as 2, the
    symmetric plane's upper triangle, V*V channels for any other alpha plus
    one background channel each, and with ``singlets`` the V + 1 singlet
    channels."""
    chans, rows = 0, 0
    for a in range(A):
        if a0_sep and a == 0:
            chans += 2 * V + 2
        else:
            chans += (V * (V + 1) // 2 if a == sym_a else V * V) + 1
            rows += V + 1
    return chans + (V + 1 if singlets else 0), rows


def distinct_channels(grid, cap_bq):
    """(mixture, all): the distinct per-observation factor columns of the
    pair pass, and of the pair and singlet passes together (a singlet column
    equal to a mixture column is one column)."""
    f, w = factor_tables(grid, cap_bq)
    w = w.reshape(w.shape[0], -1)
    mix = {w[:, j].tobytes() for j in range(w.shape[1])}
    both = mix | {f[:, j].tobytes() for j in range(3)}
    return len(mix), len(both)


def front_work(sizes, cfg):
    """(ops, bytes) of the front: for each real observation one add per
    distinct factor column; per slot one exp (and its normalising adds) for
    each mixture channel and the 3 singlet channels; bytes: a code byte per
    real observation and an offset per slot in."""
    cm, c = distinct_channels(cfg["grid_alpha"], cfg["cap_bq"])
    ops = sizes["obs_real"] * c + sizes["slots"] * (cm + 3) * (LOG_OPS + 3)
    nbytes = sizes["obs_real"] + 4 * sizes["slots"]
    return ops, nbytes


def pair_work_of(sizes, cfg):
    """(ops, bytes) of the pair search with the singlet term: ``pair_work``'s
    channels and rows per slot, one log per channel per cell; bytes: a SNP
    id per slot and the genotype table (3 posteriors per SNP and donor)
    in."""
    V, grid = cfg["donors"], cfg["grid_alpha"]
    A = len(grid)
    sym_a = grid.index(0.5) if 0.5 in grid else None
    chans, rows = pair_work(V, A, grid[0] == 0.0, sym_a, True)
    ops = sizes["slots"] * (chans * CHANNEL_OPS + rows * ROW_OPS) \
        + sizes["cells"] * chans * LOG_OPS
    nbytes = 4 * sizes["slots"] + F64 * cfg["snps"] * 3 * V
    return ops, nbytes


def decision_work(sizes, cfg):
    """(ops, bytes) of the decision pass: an exp and an add for each of the
    cell's V*V*A LLKs; bytes: the compact row a cell returns (the singlet
    and background LLKs, the singlet column, the A alpha-0 LLKs, seven
    values and three indices) out."""
    V, A = cfg["donors"], len(cfg["grid_alpha"])
    ops = sizes["cells"] * V * V * A * (LOG_OPS + 2)
    nbytes = F64 * sizes["cells"] * (2 * V + A + 11)
    return ops, nbytes


def window_least_s(ctx, work):
    """The least seconds of one stage over every job of the traced window:
    ``work(sizes, cfg)`` of each job's library, summed."""
    per_lib = [least_s(*work(sizes, ctx["config"])) for sizes in ctx["sizes"]]
    return sum(per_lib[job["lib"]] for job in ctx["jobs"])


def roofline_pct(ctx, work, kernels):
    """A stage's share of its roofline in %, or None when the trace holds
    none of its kernels: its least seconds over the device seconds of the
    kernels named (each kernel whose name contains one of ``kernels``)."""
    trace = ctx.get("trace")
    if trace is None:
        return None
    dev_s = sum(s for name, s in trace["kernel_s"].items()
                if any(k in name for k in kernels))
    if dev_s <= 0.0:
        return None
    return 100.0 * window_least_s(ctx, work) / dev_s
