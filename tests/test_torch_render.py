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


# ---------------------------------------------------- the barcode order

def _barcodes(kind, n):
    """``n`` barcodes of one kind: the generator's (16 ACGT letters and
    "-1"); duplicates and prefixes, up to keys of 16 equal bytes that only
    the full strings order; 2-, 3- and 4-byte UTF-8 beside ASCII; NULs."""
    rng = np.random.default_rng(n + len(kind))
    if kind == "acgt":
        return ["".join(rng.choice(list("ACGT"), 16)) + "-1"
                for _ in range(n)]
    pool = {
        "ties": ["A", "AA", "AB", "", "B", "AAB", "A" * 16, "A" * 17,
                 "A" * 16 + "B", "A" * 16 + "AB", "A" * 20, "C" * 15],
        "utf8": ["A", "\x7f", "\xe9", "\u07ff", "\u0800", "\u20ac",
                 "\ud7ff", "\ue000", "\uffff", "\U00010000",
                 "\U0001f600", "\U0010ffff", "A\u20acB", "A\xe9",
                 "\xe9" * 9, "\xe9" * 8 + "\U0001f600"],
        "nul": ["A", "A\0", "A\0B", "\0", "", "B\0" * 9, "\xe9\0"],
    }[kind]
    return [pool[j] for j in rng.integers(0, len(pool), n)]


ORDER_CASES = ([("acgt", n) for n in ROWS[:5] + [100_000]]
               + [(k, n) for k in ("ties", "utf8", "nul")
                  for n in (50, 2049, 9000)])


@pytest.mark.parametrize("kind,n", ORDER_CASES,
                         ids=[f"{k}-{n}" for k, n in ORDER_CASES])
def test_native_order_and_pack(native, kind, n):
    """``native/order.barcodes``: the order of ``CellStats.bc_order()``
    (UTF-8 bytes as unsigned, the shorter of a prefix pair first, equal
    barcodes by cell id) and ``native/render._concat``'s bytes and
    offsets, with no Python fallback taken."""
    from demuxlet_tpu_torch.native import order as border

    strs = _barcodes(kind, n)
    stats = tout.CellStats(barcodes=strs, totl=np.zeros(n, np.int64),
                           pass_=np.zeros(n, np.int64),
                           uniq=np.zeros(n, np.int64),
                           nsnp=np.zeros(n, np.int64))
    lib = tren._load()
    before = border.counts(lib)
    order, bc_concat, bc_off = border.barcodes(stats, lib)
    assert border.counts(lib) == (before[0] + 1, before[1] + n)
    assert order.dtype == np.int64
    assert order.tolist() == [i for _, i in stats.bc_order()]
    want_concat, want_off = tren._concat(strs)
    assert bc_concat == want_concat
    assert bc_off.dtype == np.int64
    assert bc_off.tolist() == want_off.tolist()
    if kind == "utf8":
        assert not bc_concat.isascii()  # 2-, 3- and 4-byte characters


@pytest.mark.parametrize("n_stats", [1, 2])
def test_one_order_a_job(native, n_stats):
    """Both native renders of one CellStats share one order and one pack
    (``dmx_order_counts``): a second CellStats, even of the same
    barcodes, builds its own."""
    from demuxlet_tpu_torch.native import order as border

    stats, sample_ids, llks, llk0s, comp, grid, filters = _inputs(
        2049, "degenerate")
    lib = tren._load()
    calls, n = border.counts(lib)
    renders = _counts()[0]
    got = []
    for _ in range(n_stats):
        s = dataclasses.replace(stats)
        got.append(_render(tout, s, sample_ids, llks, llk0s, comp, grid,
                           filters))
        assert border.barcodes(s, lib)[0] is border.barcodes(s, lib)[0]
    assert border.counts(lib) == (calls + n_stats, n + 2049 * n_stats)
    assert _counts()[0] == renders + 2 * n_stats
    assert all(g == got[0] for g in got)


@pytest.mark.parametrize("kind", ["ties", "utf8"])
def test_native_render_bytes_odd_barcodes(native, monkeypatch, kind):
    """Duplicate, prefix and multi-byte barcodes: the native renders, in
    the native order, against the Python renderer's bytes."""
    stats, sample_ids, llks, llk0s, comp, grid, filters = _inputs(
        1500, "degenerate")
    stats = dataclasses.replace(stats, barcodes=_barcodes(kind, 1500))
    got = _render(tout, stats, sample_ids, llks, llk0s, comp, grid, filters)
    monkeypatch.setattr(tren, "available", lambda: False)
    want = _render(tout, stats, sample_ids, llks, llk0s, comp, grid,
                   filters)
    assert got == want
