"""The port's native renderer (native/render.cpp): its .single, .sing2 and
.best bytes against the port's Python renderer on small calls and the JAX
package's native (snprintf) renderer on large ones, at the row counts where
the stripes change (one stripe up to 2048 rows, then two, up to four), on
the values that threaten a fixed-format or %g number, under the read
filters, and with sample IDs and barcodes long enough to outgrow any fixed
line buffer. The stripe counter shows whether striping engaged."""

import ctypes as C
import dataclasses
import io

import numpy as np
import pytest

from demuxlet_tpu.models import outputs as jout
from demuxlet_tpu.native import render as jren
from demuxlet_tpu_torch.models import outputs as tout
from demuxlet_tpu_torch.models.decision import CompactResult
from demuxlet_tpu_torch.native import render as tren

ROWS = [0, 1, 2047, 2048, 2049, 4 * 2048 + 3]
# the rows below which the Python renderer is the reference
PYTHON_ROWS = 2048

# ±0, NaN of either sign, ±inf, huge, subnormal, exact ties at 4 and 5
# places (0.03125, -0.015625, 0.0625 at 3), and the values where %.3g
# switches notation or rounds up a digit
SPECIALS = np.array([
    0.0, -0.0, np.nan, np.copysign(np.nan, -1.0), np.inf, -np.inf,
    1e300, -1e300, 5e-324, -5e-324, 0.03125, -0.015625, 0.0625, -0.00005,
    9.995e-5, 0.9995, 99950.0, 1e21, 999.5, -2.5e-5,
])
# %g switch points, reached through the posteriors' arithmetic
G_POINTS = [9.995e-5, 9.9949e-5, 0.9995, 0.99949, 1e-4, 0.5, 1.0]


def _inputs(n, variant, seed=7):
    """(stats, sample_ids, llks, llk0s, compact, grid, filters)."""
    rng = np.random.default_rng(seed + n)
    nv = 4
    if variant == "long_ids":
        sample_ids = [f"{j}" + "donor-" * 25 for j in range(nv)]
        barcodes = ["".join(rng.choice(list("ACGT"), 198)) + f"-{i % 10}"
                    for i in range(n)]
    else:
        sample_ids = [f"S{j}" for j in range(nv)]
        barcodes = ["".join(rng.choice(list("ACGT"), 16)) + f"-{i}"
                    for i in range(n)]
    grid = [0.0, 0.0625, 0.5]
    na = len(grid)
    sing = rng.normal(-80, 20, (n, nv))
    llks = rng.normal(-80, 20, (n, nv))
    llk0s = rng.normal(-90, 15, n)
    llk00 = rng.normal(-90, 15, (n, na))
    ssum = rng.uniform(0, 1, n)
    dsum = rng.uniform(0, 1, n)
    p12 = rng.normal(-70, 20, n)
    p10 = rng.normal(-80, 20, n)
    p20 = rng.normal(-80, 20, n)
    i1 = rng.integers(0, nv, n)
    max2 = sing.min(axis=1) - rng.uniform(0, 4, n)
    nsnp = rng.integers(0, 120, n)
    if variant != "long_ids":
        def plant(a):
            rows = np.arange(n) % 3 == 0
            a[rows] = rng.choice(SPECIALS, a[rows].shape)
        for a in (sing, llks, llk0s, llk00, p12, p10, p20, max2):
            plant(a)
        nsnp[::5] = 0
        # posteriors at the %g switch points: post_dbl = dsum/(ssum+dsum)
        # and post_sng = 0.5/nv/ssum when the best singlet is the max
        pts = np.arange(n) % 3 == 1
        g = np.resize(G_POINTS, int(pts.sum()))
        dsum[pts] = 1.0
        ssum[pts] = 1.0 / g - 1.0
        sing[pts, 0] = sing[pts].max(axis=1)
        i1[pts] = 0
        ssum[np.arange(n) % 11 == 2] = 0.0
    # the Python renderer takes exp(v - max_llk) in math.exp, which
    # overflows where C gives inf: keep every v - max_llk at most 0 or NaN
    max_llk = np.max(sing, axis=1) if n else np.zeros(0)
    # DBL calls on every third row; AMB on every sixth; the rest as drawn
    row = np.arange(n)
    p12[row % 3 == 2] += 1e3
    amb = row % 6 == 1
    max2[amb] = sing[amb, 0]
    i1[amb] = 0
    comp = CompactResult(
        sing_col=sing, llk_00=llk00, max_llk=max_llk, sum_single=ssum,
        sum_double=dsum, i_sing1=i1, i_sing2=rng.integers(0, nv, n),
        max_sing2=max2, best_flat=rng.integers(0, nv * nv * na, n),
        pair_llk12=p12, pair_llk10=p10, pair_llk20=p20)
    stats = tout.CellStats(
        barcodes=barcodes, totl=rng.integers(0, 500, n),
        pass_=rng.integers(0, 500, n), uniq=rng.integers(0, 300, n),
        nsnp=nsnp)
    filters = (dict(min_total=100, min_uniq=40, min_snp=10)
               if variant == "filters" else {})
    return stats, sample_ids, llks, llk0s, comp, grid, filters


def _render(out_mod, stats, sample_ids, llks, llk0s, comp, grid, filters):
    single, s2, best = io.StringIO(), io.StringIO(), io.StringIO()
    with np.errstate(all="ignore"):
        out_mod.write_single(single, stats, sample_ids, llks, llk0s,
                             **filters)
        out_mod.write_pass2_compact(stats, sample_ids, comp, grid, 0.5, s2,
                                    best, **filters)
    return single.getvalue(), s2.getvalue(), best.getvalue()


def _counts():
    """(render calls, stripes) of the port's loaded native renderer."""
    lib = tren._load()
    lib.dmx_render_counts.restype = None
    lib.dmx_render_counts.argtypes = [C.POINTER(C.c_int64)] * 2
    calls, stripes = C.c_int64(), C.c_int64()
    lib.dmx_render_counts(C.byref(calls), C.byref(stripes))
    return calls.value, stripes.value


@pytest.fixture
def native():
    if not (tren.available() and jren.available()):
        pytest.skip("native renderer not built")


@pytest.mark.parametrize("variant", ["degenerate", "filters", "long_ids"])
@pytest.mark.parametrize("n", ROWS)
def test_native_render_bytes(native, monkeypatch, n, variant):
    """The port's native renderer, striped, against the Python renderer
    (fewer than 2048 rows) or the JAX package's native renderer: identical
    .single/.sing2/.best bytes."""
    stats, sample_ids, llks, llk0s, comp, grid, filters = _inputs(n, variant)
    before = _counts()
    got = _render(tout, stats, sample_ids, llks, llk0s, comp, grid, filters)
    assert _counts()[0] == before[0] + 2  # both calls ran natively
    if n < PYTHON_ROWS:
        monkeypatch.setattr(tren, "available", lambda: False)
        want = _render(tout, stats, sample_ids, llks, llk0s, comp, grid,
                       filters)
    else:
        jstats = jout.CellStats(**dataclasses.asdict(stats))
        want = _render(jout, jstats, sample_ids, llks, llk0s, comp, grid,
                       filters)
        # the JAX package's renderer writes a .single posterior of NaN with
        # its sign ("-nan", as GCC drops its fabs of an exp()), where the
        # Python renderer, and so the port's, writes "nan"
        want = (want[0].replace("\t-nan\n", "\tnan\n"),) + want[1:]
    assert got == want
    lines = [len(t.splitlines()) for t in got]
    if variant != "filters":
        assert lines[0] == 1 + 4 * n  # every barcode has its .single lines
    if variant == "degenerate" and n:
        assert lines[2] < 1 + n  # pass 2 skipped the nsnp == 0 rows
    if variant == "long_ids" and n > 2:
        assert max(len(ln) for ln in got[2].splitlines()) > 512
        assert "\tAMB-" in got[2] and "\tDBL-" in got[2]


@pytest.mark.parametrize("n,stripes", [(1, 1), (2048, 1), (2049, 2),
                                       (3 * 2048, 3), (4 * 2048 + 3, 4)])
def test_native_render_stripes(native, n, stripes):
    """ceil(rows / 2048) stripes, at most four, on each render call."""
    stats, sample_ids, llks, llk0s, comp, grid, filters = _inputs(
        n, "degenerate")
    calls, used = _counts()
    _render(tout, stats, sample_ids, llks, llk0s, comp, grid, filters)
    assert _counts() == (calls + 2, used + 2 * stripes)


@pytest.mark.parametrize("lines", [0, 1, 2, 500, 20000])
def test_emit_writes_the_c_bytes(lines):
    """``native/emit.emit`` writes a C buffer's UTF-8 text whole, multi-byte
    characters included, and nothing for an empty output (a NULL pointer
    of length 0)."""
    from demuxlet_tpu_torch.native.emit import emit

    text = "".join(f"AAAC-{i}\tdon\u00f6r\u20ac{i % 5}\t-12.34567\n"
                   for i in range(lines))
    raw = text.encode()
    buf = C.create_string_buffer(raw)
    out = C.cast(buf, C.c_char_p) if raw else C.c_char_p()
    fh = io.StringIO()
    fh.write("HEADER\n")
    emit(fh, out, len(raw))
    assert fh.getvalue() == "HEADER\n" + text
