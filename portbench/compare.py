"""The comparison that decides ``correct``.

Two numbers, each with its limit in the configuration's ``limits``:

* ``rows_gap``: the widest relative gap |got - ref| / max(1, |ref|) between
  a job's compact rows and the reference's, over every cell and field. A
  value field is compared with the reference's value of the same quantity
  (pair_llk12/10/20 at the pair and alpha the job chose); an index field
  (the best and second singlet, the best doublet) is read as the
  reference's LLK at the job's index against the reference's best, so that
  a tie broken either way reads 0 and a wrong choice reads its LLK gap.
* ``render_lines_off``: the lines of a job's .single/.sing2/.best text that
  differ from the reference's rendering of that job's own rows (an exact
  comparison: limit 0), counting missing and extra lines.
"""

from __future__ import annotations

import numpy as np

from portbench import reference

VALUE_FIELDS = ("llk", "llk0", "sing_col", "llk_00", "max_llk", "sum_single",
                "sum_double")


def _rel(got, ref):
    """Elementwise |got - ref| / max(1, |ref|); inf where one side is NaN
    or infinite and the other is not the same."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    with np.errstate(invalid="ignore", over="ignore"):
        gap = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    gap = np.where(same, 0.0, gap)
    return np.where(np.isnan(gap), np.inf, gap)


def rows_gap(got, ref, V, A):
    """(gap, field): the widest gap of ``got`` (a job's rows, dict of numpy
    arrays per field) from ``ref`` (``reference.decide``'s), and the field
    that holds it."""
    worst = (0.0, "")

    def take(field, gap):
        nonlocal worst
        m = float(np.max(gap, initial=0.0))
        if m > worst[0]:
            worst = (m, field)

    n = ref["llk"].shape[0]
    for f in VALUE_FIELDS:
        if got[f].shape != ref[f].shape:
            return float("inf"), f
        take(f, _rel(got[f], ref[f]))
    rows = np.arange(n)
    sing, ab = ref["sing_col"], ref["llk_ab"]
    i1 = np.asarray(got["i_sing1"], np.int64)
    i2 = np.asarray(got["i_sing2"], np.int64)
    best = np.asarray(got["best_flat"], np.int64)
    if (np.any((i1 < 0) | (i1 >= V) | (i2 < 0) | (i2 >= V) | (i1 == i2))
            or np.any((best < 0) | (best >= V * V * A))):
        return float("inf"), "index out of range"
    jb, kb, xb = best // (V * A), (best // A) % V, best % A
    if np.any((jb == kb) | (xb == 0)):
        return float("inf"), "best_flat outside the doublet mask"
    take("i_sing1", _rel(sing[rows, i1], sing[rows, ref["i_sing1"]]))
    take("i_sing2", _rel(sing[rows, i2], ref["max_sing2"]))
    take("max_sing2", _rel(got["max_sing2"], ref["max_sing2"]))
    take("best_flat", _rel(ab[rows, jb, kb, xb], ref["pair_llk12"]))
    take("pair_llk12", _rel(got["pair_llk12"], ab[rows, jb, kb, xb]))
    take("pair_llk10", _rel(got["pair_llk10"], ab[rows, jb, 0, xb]))
    take("pair_llk20", _rel(got["pair_llk20"], ab[rows, kb, 0, xb]))
    return worst


def render_lines_off(text, rows, stats, sample_ids, cfg):
    """Lines of the job's text (single, sing2, best strings) that differ
    from the reference's rendering of the job's rows."""
    want = reference.render(rows, stats, sample_ids, cfg)
    off = 0
    for got, ref in zip(text, want):
        lines = got.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        off += sum(a != b for a, b in zip(lines, ref))
        off += abs(len(lines) - len(ref))
    return off


def checks(values, limits):
    """{name: {"value", "limit"}} and whether every value is within its
    limit."""
    out = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in values.items())
    return out, ok
