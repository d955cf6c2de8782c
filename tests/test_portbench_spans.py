"""The benchmark's reading of the port's spans, on the CPU:
``portbench.tracing.summarize`` on synthetic traces (an idle gap under a
program span, which torch exports as a cpu_op event, named by it), the
per-layer readers of the engine's ``phase_s``, and a traced run of the
accepted harness over the program."""

import json
import os
import random
import subprocess
import sys

import pytest

from portbench import harness, tracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# summarize's output on synthetic_trace(seed, demux=False) for each seed,
# as the summarize before the program's spans gave it
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "portbench_summarize_fixture.json")
SEEDS = (1, 2, 3)
MAIN, GPU = 101, 7
NEW_METRICS = {
    "setup.obs_passes.ms_per_job": "ms",
    "setup.tables.ms_per_job": "ms",
    "prep.ns_per_slot": "ns/slot",
}
# the cells the benchmark had when those metrics came, which their
# accepted entries list
SPAN_CELLS = ["kang8_a2.cells", "onek1k14_a2.cells", "kang8_a2.unfiltered"]
# the fast-mode cell: the libraries and every host layer of kang8_a2.cells,
# so it joined the lists of the host layers' metrics when it came
FAST_CELL = "kang8_a2_fast.cells"
# the 14-donor pool's raw lane: the cells traffic's host layers and the
# tiled exact route, so it joined every list that held both the 8-donor raw
# lane and the 14-donor cells when it came
RAW_TILED = "onek1k14_a2.unfiltered"
# the cells that run the exact route
EXACT_CELLS = SPAN_CELLS + ["kang64_a2.cells", RAW_TILED]
# the metrics of the pair route and the per-line render, for pools of any
# size: (unit, better, source, layer, the cells they list; None: every
# cell of the benchmark)
POOL_METRICS = {
    # the exact route's kernels and gather: none of them in fast mode
    "pair_route.device_ms_per_kbarcode": (
        "ms/kbarcode", "lower", "device_trace", "kernels", EXACT_CELLS),
    "dispatch.pair.fraction": (
        "fraction", "lower", "program_counter", "dispatch", None),
    "render.ns_per_line": ("ns/line", "lower", "host_clock", "render", None),
    # K7' + K6': the 64-donor pool at their widest, and the 14-donor raw
    # lane
    "tiled_pair_roofline": (
        "%", "higher", "device_trace", "kernels",
        ["kang64_a2.cells", RAW_TILED]),
}


class _Trace:
    """Chrome-trace events in the form torch.profiler exports them."""

    def __init__(self):
        self.events, self.ext = [], 0
        self.demux_cat = "cpu_op"

    def span(self, name, tid, ts, dur, cat=None):
        if cat is None:
            cat = (self.demux_cat if name.startswith("demux.")
                   else "user_annotation")
        self.events.append(dict(ph="X", cat=cat, name=name, pid=1, tid=tid,
                                ts=ts, dur=dur))

    def op(self, name, tid, ts, dur, kernels=()):
        """A cpu_op, and the device work it launched: (cat, name, ts,
        dur) each."""
        self.ext += 1
        self.events.append(dict(ph="X", cat="cpu_op", name=name, pid=1,
                                tid=tid, ts=ts, dur=dur,
                                args={"External id": self.ext}))
        for cat, kname, kts, kdur in kernels:
            self.events.append(dict(ph="X", cat=cat, name=kname, pid=0,
                                    tid=GPU, ts=kts, dur=kdur,
                                    args={"External id": self.ext}))


def synthetic_trace(seed, demux, demux_cat="cpu_op"):
    """A traced window of a few jobs: the benchmark's spans on the main
    thread, aten ops there and on a second thread, kernels, copies and
    sets on the device, the device's own annotations; with ``demux``, the
    program's spans too (exported as ``demux_cat`` events), the prep spans
    on two pool threads."""
    rng = random.Random(seed)
    tr = _Trace()
    tr.demux_cat = demux_cat
    t = 1000.0
    tr.span("portbench.window", MAIN, t, 0.0)
    win = tr.events[-1]
    for job in range(rng.randint(2, 4)):
        j0 = t = t + rng.uniform(5, 50)
        ctor = rng.uniform(20, 80)
        tr.span("portbench.engine_ctor", MAIN, t, ctor)
        if demux:
            tr.span("demux.engine_init", MAIN, t + 2, ctor - 4)
        t += ctor + 1
        rc0 = t
        setup = rng.uniform(300, 500)
        if demux:
            tr.span("demux.setup", MAIN, t, setup)
            a = t + 3
            for name, share in (("setup.nsnp", 0.3), ("setup.wire_cfg", 0.3),
                                ("setup.tables", 0.1), ("setup.blocks", 0.05)):
                d = setup * share
                tr.span("demux." + name, MAIN, a, d)
                a += d + 1
        t += setup
        for blk in range(rng.randint(2, 5)):
            wait = rng.uniform(5, 60)
            if demux:
                tr.span("demux.prep_wait", MAIN, t, wait)
                tr.span("demux.prep", 200 + blk % 2, t - 80, 80 + wait)
            t += wait
            disp = rng.uniform(20, 40)
            if demux:
                tr.span("demux.dispatch", MAIN, t, disp)
                tr.span("demux.dispatch.h2d", MAIN, t + 1, disp / 3)
            tr.op("aten::copy_", MAIN, t + 2, disp / 4, [(
                "gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                t + disp / 4 + 3, 5)])
            kt = t + disp / 2
            tr.op("aten::empty", MAIN, kt - 4, 2)
            tr.op("front_exact", MAIN, kt, 3, [(
                "kernel", "void front_exact_kernel<8>(double const*, int)",
                kt + 20, rng.uniform(10, 30))])
            tr.op("pair_exact", MAIN, kt + 4, 3, [(
                "kernel", "void pair_exact_kernel<8, 2>(double*)",
                kt + 60, rng.uniform(30, 90))])
            tr.op("aten::fill_", MAIN, kt + 8, 2, [(
                "gpu_memset", "Memset (Device)", kt + 200, 1)])
            tr.op("aten::mul", MAIN, kt + 11, 2, [(
                "kernel", "void at::native::vectorized_elementwise_kernel"
                "<4, at::native::MulFunctor<double>>(int)", kt + 205, 4)])
            tr.op("aten::sum", 300, kt, 5)  # another thread's op
            t += disp
        fetch = rng.uniform(80, 200)
        if demux:
            tr.span("demux.fetch", MAIN, t, fetch)
            tr.span("demux.fetch.readback", MAIN, t + 1, fetch * 0.6)
            tr.span("demux.fetch.unpack", MAIN, t + 2 + fetch * 0.6,
                    fetch * 0.3)
        tr.op("aten::cat", MAIN, t + 2, 5, [(
            "kernel", "void at::native::CatArrayBatchedCopy<double>(int)",
            t + 10, 6)])
        tr.op("aten::to", MAIN, t + 8, fetch * 0.5)
        tr.op("aten::copy_", MAIN, t + 9, fetch * 0.5 - 2, [(
            "gpu_memcpy", "Memcpy DtoH (Device -> Pageable)",
            t + fetch * 0.5 - 4, 3)])
        t += fetch
        if demux:
            tr.span("demux.finish", MAIN, t, 10)
        t += 12
        tr.span("portbench.run_compact", MAIN, rc0, t - rc0)
        stats = rng.uniform(1, 5)
        tr.span("portbench.cell_stats", MAIN, t, stats)
        if demux:
            tr.span("demux.cell_stats", MAIN, t + 0.1, stats - 0.2)
        t += stats + 0.5
        r0 = t
        for part in ("single", "pass2"):
            d = rng.uniform(300, 700)
            if demux:
                tr.span("demux.render." + part, MAIN, t, d)
                a = t + 1
                for name, share in (("order", 0.05), ("pack", 0.05),
                                    ("native", 0.7), ("emit", 0.15)):
                    tr.span("demux.render." + name, MAIN, a, d * share)
                    a += d * share + 0.5
            t += d + 1
        tr.span("portbench.render", MAIN, r0, t - r0)
        tr.span("portbench.job", MAIN, j0, t - j0)
        # a device annotation under a benchmark span's name, on the stream
        tr.span("portbench.job", GPU, j0 + 10, t - j0 - 20,
                cat="gpu_user_annotation")
        tr.span("portbench.keep", MAIN, t + 1, 30)
        t += 32
    win["dur"] = t + 5 - win["ts"]
    return {"traceEvents": tr.events}


def _summary(tmp_path, trace):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    return tracing.summarize(str(path))


@pytest.mark.parametrize("seed", SEEDS)
def test_benchmark_spans_alone_read_as_before(tmp_path, seed):
    """A trace with only the benchmark's spans gives the device ops and the
    idle gaps that summarize gave it before it read the program's spans."""
    with open(FIXTURE) as fh:
        want = json.load(fh)[str(seed)]
    got = _summary(tmp_path, synthetic_trace(seed, demux=False))
    assert got["device_ops"] == want["device_ops"]
    assert got["idle_gaps"] == want["idle_gaps"]
    assert got["busy_s"] == want["busy_s"]
    assert got["kernel_s"] == want["kernel_s"]


def _events(tr):
    return {"traceEvents": tr.events}


# the gaps of _gap_trace(cat), in microseconds: exported as cpu_op events
# (torch's C++ range) the program's spans name a gap as the innermost op
# under the benchmark's span; an aten op inside one still wins
GAPS = {
    "cpu_op": {"window/python": 200, "run_compact/demux.setup": 200,
               "run_compact/demux.setup.wire_cfg": 150,
               "run_compact/aten::add": 50, "run_compact/python": 340,
               "run_compact/aten::mul": 10},
    # record_function ranges (user_annotation): neither span nor op
    "user_annotation": {"window/python": 200, "run_compact/python": 690,
                        "run_compact/aten::add": 50,
                        "run_compact/aten::mul": 10},
}


@pytest.mark.parametrize("cat", sorted(GAPS))
def test_a_gap_is_named_by_the_innermost_program_span(tmp_path, cat):
    """An idle gap under a program span reads <benchmark span>/demux.<span>
    when torch exports the span as a cpu_op event, and the benchmark
    span's own name otherwise; under only a benchmark span it keeps that
    span's name."""
    tr = _Trace()
    tr.demux_cat = cat
    tr.span("portbench.window", MAIN, 0, 1000)
    tr.span("portbench.run_compact", MAIN, 100, 800)
    tr.span("demux.setup", MAIN, 100, 400)
    tr.span("demux.setup.wire_cfg", MAIN, 200, 200)
    tr.op("aten::add", MAIN, 250, 50)
    tr.op("aten::mul", MAIN, 550, 10,
          [("kernel", "void elementwise_kernel(int)", 600, 50)])
    got = dict(_summary(tmp_path, _events(tr))["idle_gaps"])
    assert got == pytest.approx({k: v / 1e6 for k, v in GAPS[cat].items()},
                                rel=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_program_spans_take_the_gaps_they_cover(tmp_path, seed):
    """With the program's spans in the trace the device ops are unchanged,
    and the gaps the benchmark put under run_compact and render split
    among demux.* names."""
    before = _summary(tmp_path, synthetic_trace(seed, demux=False))
    after = _summary(tmp_path, synthetic_trace(seed, demux=True))
    assert after["device_ops"] == before["device_ops"]
    assert after["busy_s"] == before["busy_s"]
    assert after["kernel_s"] == before["kernel_s"]
    gaps = dict(after["idle_gaps"])
    assert "render/demux.render.native" in gaps
    assert "run_compact/demux.setup.nsnp" in gaps
    old = dict(before["idle_gaps"])
    assert gaps.get("render/python", 0.0) < 0.1 * old["render/python"]
    assert gaps.get("run_compact/python", 0.0) < old["run_compact/python"]


def _job_rec(barcodes, phase_s):
    return dict(job=2.0, barcodes=barcodes, phase_s=phase_s, h2d_bytes=10,
                engine_ctor=0.01, cell_stats=0.001, render=0.5, lib=0)


PARENT_PHASES = dict(setup=0.4, prep=0.3, prep_wait=0.1, dispatch=0.05,
                     fetch=0.01)
# the library the job records ran on: 1,000 covered (cell, SNP) slots
SIZES = [dict(cells=1000, slots=1000, obs_real=1500)]


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_new_readers_read_none_without_their_input(name):
    """Job records that lack what the reader reads (no setup.* keys, no
    prep; no jobs; a library without covered slots): None, never 0."""
    read = harness.load_reader(REPO, name)
    bare = {k: v for k, v in PARENT_PHASES.items() if k != "prep"}
    empty = [dict(SIZES[0], slots=0)]
    for jobs, sizes in (([_job_rec(1000, bare)], SIZES), ([], SIZES),
                        ([_job_rec(1000, bare)], empty)):
        assert read(dict(jobs=jobs, trace=None, sizes=sizes)) is None


def test_parent_records_give_prep_alone():
    """A program before its spans (the phase_s keys it had) gives
    prep.ns_per_slot, whose prep it had, and None for the other two."""
    ctx = dict(jobs=[_job_rec(1000, PARENT_PHASES)], sizes=SIZES,
               trace={"busy_s": 0.1})
    got = {n: harness.load_reader(REPO, n)(ctx) for n in NEW_METRICS}
    assert got == dict(dict.fromkeys(NEW_METRICS),
                       **{"prep.ns_per_slot": pytest.approx(0.3e6)})


def test_new_readers_read_their_input():
    phases = dict(PARENT_PHASES, **{"setup.nsnp": 0.2,
                                    "setup.wire_cfg": 0.1,
                                    "setup.tables": 0.03})
    jobs = [_job_rec(2000, phases), _job_rec(2000, phases)]
    ctx = dict(jobs=jobs, sizes=SIZES, trace=None)
    got = {n: harness.load_reader(REPO, n)(ctx) for n in NEW_METRICS}
    assert got == pytest.approx({
        "setup.obs_passes.ms_per_job": 300.0,
        "setup.tables.ms_per_job": 30.0,
        "prep.ns_per_slot": 0.6 / 2000 * 1e9})


def test_new_metrics_in_the_benchmark():
    """The new metrics are per-layer entries of every cell the benchmark
    had when they came, of the fast-mode cell and of the 14-donor raw
    lane, with their units, each with a reader."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = [w["name"] for w in bench["workloads"]]
    assert cells[:len(SPAN_CELLS)] == SPAN_CELLS
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, unit in NEW_METRICS.items():
        m = entries[name]
        assert m["unit"] == unit and m["better"] == "lower"
        assert m["source"] == "program_counter"
        assert m["workloads"] == SPAN_CELLS + [FAST_CELL, RAW_TILED]
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics",
                                           name + ".py"))
    for cell in SPAN_CELLS + [FAST_CELL, RAW_TILED]:
        per_layer = harness.load_cell(REPO, cell)[4]
        assert set(NEW_METRICS) <= {m["name"] for m in per_layer}


def test_traced_run_reads_the_programs_spans(tmp_path):
    """A traced run of the benchmark's tiny CPU cell over the program:
    the result line carries the new metrics, set-up's passes within its
    whole, and the window's idle time falls under demux.* names inside
    the benchmark's run_compact and render spans (among all the gaps the
    trace names)."""
    # a process of its own: the run refuses to count where JAX is loaded
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'portbench', 'tests')!r})\n"
        "from portbench_tiny import run_tiny, tiny_root\n"
        # every named gap in the line, not the ten longest: on this cell
        # the render takes well under a tenth of the window
        "from portbench import tracing\n"
        "tracing.summarize.__defaults__ = (None,)\n"
        "torch.set_num_threads(2)\n"
        f"rc, res, err = run_tiny(tiny_root({str(tmp_path)!r}),\n"
        "                         seed=2 ** 31 + 5, traced=True)\n"
        "print(json.dumps([rc, res, err]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc, res, err = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rc == 0, err
    assert res["correct"] is True, err
    got = {n: res["metrics"][n] for n in NEW_METRICS}
    for name, unit in NEW_METRICS.items():
        assert got[name]["unit"] == unit and got[name]["value"] > 0
    passes = got["setup.obs_passes.ms_per_job"]["value"]
    assert passes + got["setup.tables.ms_per_job"]["value"] <= (
        res["metrics"]["engine_setup.ms_per_job"]["value"])
    names = [k for k, _ in res["breakdown"]["idle_gaps"]]
    assert any(k.startswith("run_compact/demux.") for k in names), names
    assert any(k.startswith("render/demux.render.") for k in names), names


def test_pool_metrics_in_the_benchmark():
    """The pair route's and the per-line render's metrics: per-layer
    entries after the ones accepted before them, in one run, with their
    units, sources and layers (each layer a name those entries use), each
    with a reader; the tiled roofline in the 64-donor cell and the
    14-donor raw lane, the exact pair route's device time in the exact
    cells, the others in every cell, each cell's line asking its
    reader."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = [w["name"] for w in bench["workloads"]]
    assert set(EXACT_CELLS + [FAST_CELL]) <= set(cells)
    names = [m["name"] for m in bench["per_layer"]]
    first = names.index(next(iter(POOL_METRICS)))
    assert names[first:first + len(POOL_METRICS)] == list(POOL_METRICS)
    entries = {m["name"]: m for m in bench["per_layer"]}
    old_layers = {m["layer"] for m in bench["per_layer"][:first]}
    for name, (unit, better, source, layer, wl) in POOL_METRICS.items():
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["layer"]) == (
            unit, better, source, layer), name
        assert layer in old_layers and m["moves"] == "barcodes_per_s"
        assert m["workloads"] == (wl or cells), name
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics",
                                           name + ".py"))
        for cell in m["workloads"]:
            assert name in {x["name"] for x in
                            harness.load_cell(REPO, cell)[4]}


# device seconds of a traced 64-donor window, by kernel name as the trace
# gives it (torch 2.11 on an H100): the tiled pair search, its O(V)
# channels, the g gather (aten::gather), and kernels outside the pair
# route, the scatter twin of the gather's kernel among them
POOL_KERNELS = {
    "void pair_tiled_exact_kernel<16>(dmx::TiledParams<double>)": 1.5,
    "void extras_exact_kernel<128>(dmx::ExtrasParams<double>)": 0.5,
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<false, "
    "at::native::OpaqueType<8>, long>::operator()": 0.25,
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<true, long, long>"
    "::operator()<at::native::ReduceAdd": 0.0625,
    "void front_exact_kernel<true>(double const*, int)": 0.75,
    "void at::native::CatArrayBatchedCopy<double>(int)": 0.125,
}
POOL_CFG = dict(donors=64, grid_alpha=[0.0, 0.5], cap_bq=40, snps=50000)


def _pool_ctx(phase_s, trace, jobs=2):
    return dict(jobs=[_job_rec(2000, phase_s) for _ in range(jobs)],
                sizes=SIZES, config=POOL_CFG, trace=trace)


def test_pool_readers_read_their_input():
    """Two 2,000-barcode jobs of 2 s each, 0.25 s of dispatch.pair and a
    0.5 s render each, on a 64-donor pool."""
    from portbench import roofline

    trace = dict(busy_s=4.0, window_s=4.5, kernel_s=POOL_KERNELS)
    ctx = _pool_ctx(dict(PARENT_PHASES, **{"dispatch.pair": 0.25}), trace)
    got = {n: harness.load_reader(REPO, n)(ctx) for n in POOL_METRICS}
    least = 2 * roofline.least_s(*roofline.pair_work_of(SIZES[0],
                                                        POOL_CFG))
    assert got == pytest.approx({
        "pair_route.device_ms_per_kbarcode": 2.25e3 / 4.0,
        "dispatch.pair.fraction": 0.5 / 4.0,
        "render.ns_per_line": 1e9 * 1.0 / (2 * (2000 * 129 + 3)),
        "tiled_pair_roofline": 100.0 * least / 2.0}, rel=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_pool_readers_on_an_unrolled_window(seed):
    """On the summaries of the fixture's traces (K3' windows, an 8-donor
    pool), the pair route reads K3''s seconds; the tiled roofline finds
    no tiled kernel and reads None; a program before the dispatch.pair
    span (the parent's phase_s keys) gives None for its fraction."""
    with open(FIXTURE) as fh:
        summary = json.load(fh)[str(seed)]
    cfg = dict(POOL_CFG, donors=8)
    ctx = dict(_pool_ctx(PARENT_PHASES, summary), config=cfg)
    got = {n: harness.load_reader(REPO, n)(ctx) for n in POOL_METRICS}
    k3 = sum(v for k, v in summary["kernel_s"].items()
             if "pair_exact_kernel" in k)
    assert k3 > 0.0
    assert got == dict(
        {"pair_route.device_ms_per_kbarcode": pytest.approx(k3 / 4.0 * 1e3),
         "render.ns_per_line": pytest.approx(1e9 / (2 * (2000 * 17 + 3)))},
        **{"dispatch.pair.fraction": None, "tiled_pair_roofline": None})


def test_pool_readers_read_none_without_their_input():
    """No trace (an untraced run), a trace with no kernel of the pair
    route (the CPU), no jobs: None, never 0 and never an error."""
    phases = dict(PARENT_PHASES, **{"dispatch.pair": 0.25})
    bare = dict(busy_s=0.0, window_s=1.0, kernel_s={})
    for name in ("pair_route.device_ms_per_kbarcode",
                 "tiled_pair_roofline"):
        read = harness.load_reader(REPO, name)
        for ctx in (_pool_ctx(phases, None), _pool_ctx(phases, bare),
                    _pool_ctx(phases, dict(bare, kernel_s=POOL_KERNELS),
                              jobs=0)):
            assert read(ctx) is None, name
    for name in ("dispatch.pair.fraction", "render.ns_per_line"):
        assert harness.load_reader(REPO, name)(
            _pool_ctx(phases, None, jobs=0)) is None, name
