"""The port's spans and counters (``demuxlet_tpu_torch/utils/spans.py``) on
the CPU: a job under torch.profiler holds every span of the engine, the
set-up's parts inside the set-up and one prep span a block on the
prefetch threads; each ``phase_s`` key is its spans' summed time and the
other spans are on the trace alone; ``counts`` holds the slots of the
blocks as shipped, the tiled pair kernel's tile items and the bytes of
the g gathers, on a 3-, a 14- and a 64-donor pool, and in fast mode the
entries of the front's count tables; each mode's block step is its front
and then the rest; with no profiler running no range is entered."""

import io
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from demuxlet_tpu_torch.host.csr import CsrPileup
from demuxlet_tpu_torch.models import decision as TD
from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.models import outputs
from demuxlet_tpu_torch.utils import spans

torch.set_num_threads(2)

CPU = torch.device("cpu")
GRID = [0.0, 0.5]
# the spans of a run_compact job, cell_stats and the native render
JOB_SPANS = ("engine_init", "setup", "setup.nsnp", "setup.wire_cfg",
             "setup.tables", "setup.blocks", "prep", "prep_wait",
             "dispatch", "dispatch.h2d", "dispatch.front", "dispatch.pair",
             "fetch",
             "fetch.readback",
             "fetch.unpack", "finish", "cell_stats", "render.single",
             "render.pass2", "render.order", "render.pack", "render.native",
             "render.emit")


def _pileup(seed, skewed, n_cells=40, NS=400, V=3):
    """A pileup whose cells cover 10-30 or 150-250 SNPs in turn (skewed:
    ``_blocks``' coverage sort engages on blocks of 8) or 100-120 each
    (it does not); 1-4 UMIs a slot."""
    rng = np.random.default_rng(seed)
    obs = []
    for c in range(n_cells):
        lo, hi = ((10, 31) if c % 2 else (150, 251)) if skewed else (100, 121)
        snps = np.sort(rng.choice(NS, size=int(rng.integers(lo, hi)),
                                  replace=False))
        for s in snps:
            for _ in range(1 + (rng.random() < 0.3) * int(rng.integers(1, 4))):
                obs.append((c, s, int(rng.random() < 0.5),
                            int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    z = np.zeros(n_cells)
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], NS, ["B%04d" % i for i in range(n_cells)],
        z, z, z, obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8))
    return csr, rng.dirichlet(np.ones(3), size=(NS, V))


def _job(csr, gps):
    """One CLI job after ingest: the engine, run_compact, cell_stats, the
    two renders into memory."""
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, device=CPU)
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    stats = TE.cell_stats(csr)
    ids = csr.sample_ids
    outputs.write_single(io.StringIO(), stats, ids, llks, llk0s)
    outputs.write_pass2_compact(stats, ids, comp, GRID, 0.5, io.StringIO(),
                                io.StringIO())
    return eng


def _traced(tmp_path, fn):
    """fn() under torch.profiler with every thread recorded: (its result,
    the trace's demux.* events by name without the prefix, the calling
    thread's tid)."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=spans.profiler_config()) as prof:
        with torch.autograd.profiler.record_function("caller"):
            out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    caller = next(e["tid"] for e in events if e.get("name") == "caller")
    by = {}
    for e in events:
        if e.get("name", "").startswith(spans.PREFIX) and "dur" in e:
            by.setdefault(e["name"][len(spans.PREFIX):], []).append(e)
    return out, by, caller


@pytest.fixture(scope="module")
def traced_job(tmp_path_factory):
    csr, gps = _pileup(5, skewed=True)
    return _traced(tmp_path_factory.mktemp("spans"), lambda: _job(csr, gps))


def test_every_span_of_a_job_is_traced(traced_job):
    _, by, caller = traced_job
    assert set(by) == set(JOB_SPANS)
    blocks = 5  # 40 cells in blocks of 8
    for name in ("prep_wait", "dispatch", "dispatch.h2d", "dispatch.front",
                 "dispatch.pair"):
        assert len(by[name]) == blocks, name
        assert {e["tid"] for e in by[name]} == {caller}, name
    assert len(by["prep"]) == blocks
    assert caller not in {e["tid"] for e in by["prep"]}
    for name in JOB_SPANS:
        if name != "prep":
            assert {e["tid"] for e in by[name]} == {caller}, name


def _inside(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_spans_nest_as_the_job_does(traced_job):
    _, by, _ = traced_job
    (setup,) = by["setup"]
    for name in ("setup.nsnp", "setup.wire_cfg", "setup.tables",
                 "setup.blocks"):
        (part,) = by[name]
        assert _inside(part, setup), name
    for name in ("dispatch.h2d", "dispatch.front", "dispatch.pair"):
        for part in by[name]:
            assert any(_inside(part, d) for d in by["dispatch"]), name
    (fetch,) = by["fetch"]
    for name in ("fetch.readback", "fetch.unpack"):
        assert _inside(by[name][0], fetch), name
    assert by["finish"][0]["ts"] >= fetch["ts"] + fetch["dur"]
    (single,), (pass2,) = by["render.single"], by["render.pass2"]
    for name in ("render.order", "render.pack", "render.native",
                 "render.emit"):
        assert len(by[name]) == 2, name
        assert sum(_inside(e, single) for e in by[name]) == 1, name
        assert sum(_inside(e, pass2) for e in by[name]) == 1, name


def test_phase_s_is_its_spans_time(traced_job):
    """Each phase_s key equals its spans' summed duration to within 1 ms
    (the clock is read inside the range); the other spans have no key."""
    eng, by, _ = traced_job
    assert set(eng.phase_s) == set(TE.PHASES) < set(JOB_SPANS)
    for name in TE.PHASES:
        traced = sum(e["dur"] for e in by.get(name, ())) / 1e6
        assert eng.phase_s[name] == pytest.approx(traced, abs=1e-3), name
        assert eng.phase_s[name] <= traced, name
    assert eng.phase_s["setup"] >= sum(
        eng.phase_s[k] for k in TE.PHASES if k.startswith("setup."))


@pytest.mark.parametrize("skewed", [True, False], ids=["sorted", "natural"])
def test_counts_are_the_runs_slots(monkeypatch, skewed):
    """slots_kernel is the padded cells times padded slots of the blocks
    as the block step gets them, more than the covered slots of the run's
    cells, with coverage sorting engaged and not; g_bytes is (3V+3) f64
    rows over those slots; a pool of 3 donors takes K3', so no tile item
    is counted."""
    csr, gps = _pileup(7, skewed)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, device=CPU)
    blocks, pads = eng._blocks(csr.nbcs, csr)
    assert (pads is not None) == skewed
    shipped = []
    step = TD.compact_step_body_exact

    def spy(parts, *args, **kw):
        shipped.append(tuple(parts.idx.shape))
        return step(parts, *args, **kw)

    monkeypatch.setattr(TD, "compact_step_body_exact", spy)
    eng.run_compact(csr, 0.5)
    nsnp = csr.n_snps_all()
    slots = sum(b * s for b, s in shipped)
    assert eng.counts == {"slots_kernel": slots, "pair_tile_items": 0,
                          "g_bytes": (3 * 3 + 3) * slots * 8,
                          "front_entries": 0}
    assert len(shipped) == len(blocks)
    for (b, s), cells, pad in zip(shipped, blocks,
                                  pads or [None] * len(blocks)):
        # the native packer pads a block to a multiple of 32 cells
        assert b >= len(cells) and s >= nsnp[cells].max()
        if pad is not None:
            assert s == pad
    assert eng.counts["slots_kernel"] > nsnp.sum()


@pytest.mark.parametrize("V", [14, 64])
def test_pair_route_counts_and_span(monkeypatch, V):
    """On the tiled route (V=14: one 16-tile; V=64: four an axis, the
    symmetric plane's 10 upper-triangle tiles), each block counts the
    tile items its K7' is given and the (3V+3) f64 rows it gathers over
    its slots; ``run()`` counts the same; the pair route is a span
    inside dispatch, one a block."""
    from demuxlet_tpu_torch.ops import pair_tiled as PT

    csr, gps = _pileup(17 + V, skewed=True, n_cells=24, V=V)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, device=CPU)
    shipped, items = [], []
    step, tiled = TD.compact_step_body_exact, PT.pair_tiled_plain

    def spy(parts, *args, **kw):
        shipped.append(tuple(parts.idx.shape))
        return step(parts, *args, **kw)

    def spy_tiled(t, g, V, A, plan, expand):
        items.append(len(plan.items))
        return tiled(t, g, V, A, plan, expand)

    monkeypatch.setattr(TD, "compact_step_body_exact", spy)
    monkeypatch.setattr(PT, "pair_tiled_plain", spy_tiled)
    eng.run_compact(csr, 0.5)
    n_items = {14: 1, 64: 10}[V]
    assert len(shipped) == 3 and items == [n_items] * 3
    slots = sum(b * s for b, s in shipped)
    assert eng.counts == {"slots_kernel": slots,
                          "pair_tile_items": n_items * 3,
                          "g_bytes": (3 * V + 3) * slots * 8,
                          "front_entries": 0}
    assert 0.0 < eng.phase_s["dispatch.pair"] < eng.phase_s["dispatch"]
    first = dict(eng.counts)
    eng.run(csr)
    assert eng.counts == first and items == [n_items] * 6
    assert 0.0 < eng.phase_s["dispatch.pair"] < eng.phase_s["dispatch"]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_front_and_pair_spans_of_each_mode(mode):
    """Each mode's block step is the span dispatch.front and then the span
    dispatch.pair, both inside dispatch, in run_compact and in run():
    fast mode's front the count scatters, the LUT contraction and the GL
    table, exact mode's K2'."""
    csr, gps = _pileup(19, skewed=True)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, mode=mode, device=CPU)
    for run in (lambda: eng.run_compact(csr, 0.5), lambda: eng.run(csr)):
        run()
        front, pair = eng.phase_s["dispatch.front"], eng.phase_s[
            "dispatch.pair"]
        assert front > 0.0 and pair > 0.0
        assert front + pair < eng.phase_s["dispatch"]


@pytest.mark.parametrize("mode", ["exact", "fast"])
def test_front_entries_are_the_count_tables(monkeypatch, mode):
    """counts["front_entries"] is the number of entries the fast front
    scatters into its count tables, each adding 1.0 (the dense lanes and
    the deep-lane tail, pads included, so the tables' sums), and the
    entries the decoded blocks carry, in run_compact and in run(); 0 in
    exact mode, whose front scatters nothing."""
    from demuxlet_tpu_torch.ops import front as TF

    csr, gps = _pileup(23, skewed=True)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, mode=mode, device=CPU)
    tables, carried = [], []
    counts, decode = TF._counts, TE.decode

    def spy_counts(c, R):
        tables.append(counts(c, R))
        return tables[-1]

    def spy_decode(bufs, meta):
        parts = decode(bufs, meta)
        tails = 0 if parts.tail is None else parts.tail[0].numel()
        carried.append((parts.dense.numel(), tails))
        return parts

    monkeypatch.setattr(TF, "_counts", spy_counts)
    monkeypatch.setattr(TE, "decode", spy_decode)
    for run in (lambda: eng.run_compact(csr, 0.5), lambda: eng.run(csr)):
        tables.clear()
        carried.clear()
        run()
        got = eng.counts["front_entries"]
        if mode == "exact":
            assert got == 0 and not tables
            continue
        assert len(tables) == len(carried) == 5
        assert any(t for _, t in carried)  # deep lanes reach the tail
        assert got == sum(int(t.sum()) for t in tables)
        assert got == sum(d + t for d, t in carried)


def test_a_second_run_resets_the_accounting():
    """The accounting starts anew with each run; a pileup whose wire
    config is cached takes no pass over its observations again."""
    csr, gps = _pileup(9, skewed=True)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, device=CPU)
    eng.run_compact(csr, 0.5)
    first = dict(eng.counts)
    assert eng.phase_s["setup.wire_cfg"] > 0.0
    eng.run_compact(csr, 0.5)
    assert eng.counts == first
    assert eng.phase_s["setup.nsnp"] == eng.phase_s["setup.wire_cfg"] == 0.0
    res = eng.run(csr)
    assert eng.counts == first
    assert eng.phase_s["fetch"] > 0.0
    assert res.llks.shape == (csr.nbcs, 3)


def test_one_native_pass_a_pileup():
    """A first run_compact on a pileup runs the native pass over its
    observations once (the pass counter's calls + 1), timed by setup.nsnp,
    and setup.wire_cfg reads its histogram; cell_stats then takes the
    pass's distinct-SNP counts and runs no pass; a second run_compact on
    the pileup takes neither span and no pass."""
    from demuxlet_tpu_torch.native import obs

    if obs.counts() is None:
        pytest.skip("native prep not built")
    csr, gps = _pileup(13, skewed=True)
    eng = TE.DemuxEngine(gps, GRID, cell_block=8, device=CPU)
    calls = obs.counts()[0]
    eng.run_compact(csr, 0.5)
    assert obs.counts()[0] == calls + 1
    assert eng.phase_s["setup.nsnp"] > 0.0
    assert eng.phase_s["setup.wire_cfg"] > 0.0
    assert csr.code_hist(eng.cap_bq) is not None
    stats = TE.cell_stats(csr)
    np.testing.assert_array_equal(stats.nsnp, csr._n_snps_all_impl())
    assert obs.counts()[0] == calls + 1
    eng.run_compact(csr, 0.5)
    assert eng.phase_s["setup.nsnp"] == eng.phase_s["setup.wire_cfg"] == 0.0
    assert obs.counts()[0] == calls + 1


def test_no_record_function_without_a_profiler(monkeypatch):
    """With no profiler running a span enters no range (neither
    record_function nor the C++ one), and its accounting still adds up."""
    def refuse(*args, **kwargs):
        raise AssertionError("a range entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "_RANGE", refuse)
    csr, gps = _pileup(11, skewed=True)
    eng = _job(csr, gps)
    assert eng.phase_s["prep"] > 0.0 and eng.phase_s["setup"] > 0.0
    with spans.span("x") as s:
        pass
    assert s._range is None


def test_python_render_has_no_native_span(tmp_path, monkeypatch):
    """Without the native renderer each render is its one span, with none
    of the native renderer's parts inside."""
    from demuxlet_tpu_torch.native import render

    monkeypatch.setattr(render, "available", lambda: False)
    csr, gps = _pileup(13, skewed=False, n_cells=8)
    _, by, _ = _traced(tmp_path, lambda: _job(csr, gps))
    assert len(by["render.single"]) == len(by["render.pass2"]) == 1
    assert not {k for k in by if k.startswith("render.")} - {
        "render.single", "render.pass2"}


def test_span_decorates_and_accounts_on_threads(monkeypatch):
    """A decorated function's calls are each a span; spans on more threads
    than cores, switching often, add into one accounting entry without
    losing an update: on a clock that advances by 1 a reading on each
    thread, every span lasts exactly 1."""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor

    local = threading.local()

    def clock():
        local.t = getattr(local, "t", 0.0) + 1.0
        return local.t

    monkeypatch.setattr(spans, "perf_counter", clock)
    acct = {}

    @spans.span("work", acct)
    def work(x):
        return x + 1

    n = 20000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(4 * (os.cpu_count() or 1)) as pool:
            got = list(pool.map(work, range(n), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert got == list(range(1, n + 1))
    assert acct == {"work": float(n)}
    assert work.__name__ == "work"
