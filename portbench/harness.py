"""One run of one cell: set-up, the measured window of whole demultiplexing
jobs, the check against the reference, and the result line.

A job is what one CLI run of ``demuxlet_tpu_torch`` does after ingest, in
``cli._main``'s order and with the CLI's defaults: a new ``DemuxEngine``, a
new ``CsrPileup`` over the library's arrays, ``run_compact``,
``cell_stats``, and ``write_single`` and ``write_pass2_compact`` into
in-memory text. Set-up makes two libraries from the seed and runs one job on
each (which builds the kernels on a checkout's first run and warms every
shape the window uses); the window then runs jobs back to back, alternating
between the libraries, until ``--seconds`` have passed, and ends when the
last job started has finished.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import io
import json
import os
import resource
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "demuxlet_tpu")
# torch's CPU thread pool: one thread, whatever the machine's core count, so
# that idle pool threads do not spin beside the engine's prep threads and the
# renderer, and machines of another core count do the same work
TORCH_THREADS = 1


def forbidden_modules(names):
    """The names of ``FORBIDDEN`` among the top-level names (the part before
    the first dot, compared whole) of the module names given."""
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def load_cell(root, workload):
    """(cell, config, traffic, end_to_end, per_layer) of ``workload`` from
    ``root``'s BENCHMARK.json and the files it names."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(root, entry["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads",
                                                        [workload])]

    return (cell, cfg, traffic, mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def load_reader(root, name):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = os.path.join(root, "portbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Spans:
    """The benchmark's own host spans: seconds per name (and the calling
    thread's CPU seconds under ``<name>.cpu``), and, while a profiler runs,
    the same spans as ``record_function`` ranges."""

    def __init__(self, traced):
        self.traced = traced

    @contextlib.contextmanager
    def __call__(self, name, into=None):
        ctx = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            ctx = record_function("portbench." + name)
        t0, c0 = time.perf_counter(), time.thread_time()
        with ctx:
            yield
        if into is not None:
            into[name] = time.perf_counter() - t0
            into[name + ".cpu"] = time.thread_time() - c0


def run_job(lib, gps, cfg, device, span):
    """One demultiplexing job on ``lib``: (record, rows, texts). record
    holds the job's spans (seconds), the engine's counters and its barcode
    count; rows the compact rows per field; texts the .single, .sing2 and
    .best text."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from demuxlet_tpu_torch.models import outputs
    from demuxlet_tpu_torch.models.engine import DemuxEngine, cell_stats

    grid, prior = cfg["grid_alpha"], cfg["doublet_prior"]
    rec = {}
    with span("job", rec):
        with span("engine_ctor", rec):
            scl = CsrPileup(
                sample_ids=lib.sample_ids, nsnps=lib.nsnps,
                barcodes=lib.barcodes, cell_totl=lib.totl,
                cell_pass=lib.pass_, cell_uniq=lib.uniq,
                cell_ptr=lib.cell_ptr, obs_snp=lib.obs_snp,
                obs_allele=lib.obs_allele, obs_bq=lib.obs_bq)
            eng = DemuxEngine(gps, grid, cap_bq=cfg["cap_bq"],
                              cell_block=cfg["cell_block"],
                              slot_chunk=cfg["slot_chunk"], mode=cfg["mode"],
                              device=device)
        with span("run_compact", rec):
            llks, llk0s, comp = eng.run_compact(scl, prior)
        with span("cell_stats", rec):
            stats = cell_stats(scl)
        with span("render", rec):
            fs, f2, fb = io.StringIO(), io.StringIO(), io.StringIO()
            outputs.write_single(fs, stats, lib.sample_ids, llks, llk0s)
            outputs.write_pass2_compact(stats, lib.sample_ids, comp, grid,
                                        prior, f2, fb)
    rec.update(barcodes=lib.n_barcodes, phase_s=dict(eng.phase_s),
               h2d_bytes=eng.h2d_bytes, d2h_bytes=eng.d2h_bytes,
               host_table_builds=sum(eng.host_table_builds.values()),
               route=eng.route)
    rows = dict(llk=llks, llk0=llk0s)
    rows.update({k: getattr(comp, k) for k in (
        "sing_col", "llk_00", "max_llk", "sum_single", "sum_double",
        "i_sing1", "i_sing2", "max_sing2", "best_flat", "pair_llk12",
        "pair_llk10", "pair_llk20")})
    return rec, rows, (fs.getvalue(), f2.getvalue(), fb.getvalue())


def keep(kept, rows, texts):
    """Add a job's output to ``kept`` (its library's distinct outputs, as
    (rows, texts)) unless it equals one already there, so that a window
    holds one output a library and not every job's text."""
    for r, t in kept:
        if t == texts and all(np.array_equal(r[k], rows[k]) for k in rows):
            return
    kept.append((rows, texts))


def sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window(libs, gps, cfg, device, seconds, traced, log):
    """Jobs back to back, alternating libraries, for ``seconds``: (jobs,
    kept, failed, window_s, peak_bytes, trace summary or None); ``kept``
    holds each library's distinct outputs (``keep``)."""
    import torch

    span = Spans(traced)
    jobs, kept, failed = [], [[] for _ in libs], 0
    prof = contextlib.nullcontext()
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cpu0 = time.process_time()
    with prof as p:
        with span("window"):
            t0 = time.perf_counter()
            deadline, k = t0 + seconds, 0
            while time.perf_counter() < deadline:
                i, k = k % len(libs), k + 1
                try:
                    rec, rows, texts = run_job(libs[i], gps, cfg, device,
                                               span)
                except Exception:  # a job that raised counts as failed
                    failed += 1
                    traceback.print_exc()
                    continue
                rec["lib"] = i
                jobs.append(rec)
                with span("keep", rec):
                    keep(kept[i], rows, texts)
                del rows, texts
            sync(device)
            window_s = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    log(f"window: process CPU {time.process_time() - cpu0:.3f} s in "
        f"{window_s:.3f} s, peak RSS {rss / 2 ** 20:.3f} GiB")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    summary = None
    if traced:
        from portbench import tracing

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            p.export_chrome_trace(path)
            summary = tracing.summarize(path)
        summary["window_s"] = window_s
        log(f"trace: busy {summary['busy_s']:.6f} s of {window_s:.6f} s")
    return jobs, kept, failed, window_s, peak, summary


def check(libs, gps, cfg, kept, seed, device, log):
    """The comparison: every distinct output of each library's jobs
    (``kept``) has its rows compared with the reference of its library,
    and up to two of them a library (drawn from the seed) have their text
    compared with the reference's rendering of their rows. Returns
    {"rows_gap", "render_lines_off"}."""
    from portbench import compare, reference

    V, A = cfg["donors"], len(cfg["grid_alpha"])
    worst, lines_off = 0.0, 0
    rng = np.random.default_rng([seed % (1 << 64), 3])
    for i, lib in enumerate(libs):
        t0 = time.perf_counter()
        ref = reference.decide(reference.llks(lib, gps, cfg, device), cfg)
        log(f"reference: library {i} in {time.perf_counter() - t0:.3f} s")
        for rows, _ in kept[i]:
            gap, field = compare.rows_gap(rows, ref, V, A)
            if gap > worst:
                worst = gap
                log(f"rows_gap {gap!r} in {field} (library {i})")
        picks = range(len(kept[i]))
        if len(kept[i]) > 2:
            picks = rng.choice(len(kept[i]), 2, replace=False)
        stats = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                     uniq=lib.uniq, nsnp=ref["nsnp"])
        t0 = time.perf_counter()
        for j in picks:
            rows, texts = kept[i][j]
            lines_off += compare.render_lines_off(texts, rows, stats,
                                                  lib.sample_ids, cfg)
        log(f"render check: library {i}, {len(picks)} of {len(kept[i])} "
            f"distinct outputs, {time.perf_counter() - t0:.3f} s")
        del ref
    return dict(rows_gap=worst, render_lines_off=lines_off)


def library_line(lib):
    return (f"{lib.n_barcodes} barcodes ({lib.n_cells} cells, "
            f"{lib.n_doublets} doublets), {lib.n_slots} slots, "
            f"{len(lib.obs_snp)} observations ({lib.n_obs_real} of allele "
            f"0/1)")


def run(root, workload, seed, seconds, traced, t_process, device=None,
        out=sys.stdout, err=sys.stderr):
    """One run; prints the result line to ``out`` and returns the exit
    code. ``device`` None takes the CUDA card as the CLI does, and refuses
    to run without as many cards as the cell asks for."""
    def log(msg):
        print(msg, file=err, flush=True)

    cell, cfg, traffic, e2e, per_layer = load_cell(root, workload)
    import torch

    torch.set_num_threads(TORCH_THREADS)
    if device is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            log(f"{workload} needs {cell['chips']} CUDA card(s); this "
                f"machine has {have}")
            return 2
        from demuxlet_tpu_torch.utils.device import resolve_device

        device = resolve_device("auto")
        log_card(log)
    from portbench import generator

    t0 = time.perf_counter()
    gt, gps = generator.pool_gps(cfg, seed, device)
    libs = [generator.make_library(cfg, traffic, gt, seed, i, device)
            for i in range(2)]
    del gt
    if device.type == "cuda":
        torch.cuda.empty_cache()
    for i, lib in enumerate(libs):
        log(f"library {i}: {library_line(lib)}")
    log(f"libraries made in {time.perf_counter() - t0:.3f} s")

    from demuxlet_tpu_torch.native import prep, render

    kdir = os.path.join(root, "build", "kernels")
    before = set(os.listdir(kdir)) if os.path.isdir(kdir) else set()
    t0 = time.perf_counter()
    for lib in libs:  # warm-up: one job a library, every shape of the window
        rec, _, _ = run_job(lib, gps, cfg, device, Spans(False))
        log(f"warm-up job: {rec['job']:.3f} s, route {rec['route']}")
    built = sorted(set(os.listdir(kdir)) - before) if os.path.isdir(kdir) \
        else []
    built = [f for f in built if f.endswith(".so")]
    log(f"warm-up: {time.perf_counter() - t0:.3f} s, kernel libraries "
        f"built: {len(built)}; native prep {prep.available()}, native "
        f"render {render.available()}")
    # what set-up made lives to the end: keep it out of the collector's
    # passes in the window
    gc.collect()
    gc.freeze()
    setup_s = time.monotonic() - t_process

    jobs, kept, failed, window_s, peak, trace = window(
        libs, gps, cfg, device, seconds, traced, log)
    attempted = len(jobs) + failed
    done = sum(j["barcodes"] for j in jobs)
    times = [j["job"] for j in jobs]
    if len(times) >= 2:
        q = statistics.quantiles(times, n=4)
        log(f"jobs: {len(jobs)} in {window_s:.3f} s; job seconds "
            f"median {statistics.median(times):.4f}, quartiles "
            f"{q[0]:.4f}-{q[2]:.4f}")
    for part in ("engine_ctor", "run_compact", "cell_stats", "render",
                 "keep"):
        for name in (part, part + ".cpu"):
            xs = [j[name] for j in jobs]
            if len(xs) >= 2:
                q = statistics.quantiles(xs, n=4)
                log(f"  {name}: median {statistics.median(xs):.4f} s, "
                    f"quartiles {q[0]:.4f}-{q[2]:.4f}")
    if device.type == "cuda":
        torch.cuda.empty_cache()

    values = check(libs, gps, cfg, kept, seed, device, log)
    values["jobs_failed"] = failed
    from portbench import compare

    checks, ok = compare.checks(values, dict(cfg["limits"], jobs_failed=0))
    correct = bool(ok and attempted > 0)

    if traced:
        ctx = dict(jobs=jobs, config=cfg, trace=trace,
                   sizes=[dict(cells=lib.n_barcodes, slots=lib.n_slots,
                               obs_real=lib.n_obs_real) for lib in libs])
        metrics = {}
        for m in per_layer:
            v = load_reader(root, m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        have = {"barcodes_per_s": done / window_s,
                "peak_device_gib": peak / 2 ** 30, "setup_s": setup_s}
        metrics = {m["name"]: {"value": have[m["name"]], "unit": m["unit"]}
                   for m in e2e}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced and trace is not None:
        dev.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    found = forbidden_modules(sys.modules)
    if found:
        log("the run loaded " + ", ".join(found)
            + ": the benchmark runs the port without JAX or the JAX package")
        return 3
    result["checks"] = checks
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), file=out, flush=True)
    return 0


def log_card(log):
    """The card's name and power limit, on a line of its own."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        log("card: " + proc.stdout.strip().replace("\n", "; "))
    except (OSError, subprocess.SubprocessError) as exc:
        log(f"card: nvidia-smi unavailable ({exc})")
