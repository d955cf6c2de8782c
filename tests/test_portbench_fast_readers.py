"""The benchmark's readers of the fast route, on the CPU: the fast pair
search's roofline share (``portbench/roofline_fast.py``), the fast front's
and the fast pair route's device time per 1,000 barcodes and the front's
share of dispatch, each None without what it reads and a known value on a
synthetic window; the fast pair search's work counted over the covered
slots the engine's blocks hold, whatever the blocking, on the unrolled and
the tiled route; and the fast cells' entries in the benchmark."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import generator, harness, roofline, roofline_fast

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
READERS = ("fast_pair_roofline", "fast_front.device_ms_per_kbarcode",
           "dispatch.front.fraction")
# the fast pair route's kernels and g gather, the fast counterpart of
# pair_route.device_ms_per_kbarcode (after READERS in the benchmark)
ROUTE = "fast_pair_route.device_ms_per_kbarcode"
FAST_CELLS = ["kang8_a2_fast.cells", "kang64_a2_fast.cells"]
# the cells that came after the fast cell: the 64-donor pool in fast mode
# and the 14-donor pool's raw lane
NEW_CELLS = ["kang64_a2_fast.cells", "onek1k14_a2.unfiltered"]
# the accepted metrics of the layers the fast cell shares with
# kang8_a2.cells (set-up, prep, wire, dispatch, readback, render, the
# device's idle share), which the fast cell reports too
HOST_METRICS = ("render.ms_per_kbarcode", "engine_setup.ms_per_job",
                "prep_wait.fraction", "dispatch.fraction", "fetch.fraction",
                "wire.bytes_per_barcode", "device.idle_share",
                "setup.obs_passes.ms_per_job", "setup.tables.ms_per_job",
                "prep.ns_per_slot", "dispatch.pair.fraction",
                "render.ns_per_line")
CFG = dict(donors=8, grid_alpha=[0.0, 0.5], cap_bq=40, snps=50000)
SIZES = [dict(cells=1000, slots=1_000_000, obs_real=1_200_000),
         dict(cells=2000, slots=1_500_000, obs_real=1_800_000)]
# device seconds of a traced fast window by kernel name, as the card's
# trace gives them (torch 2.11, NVIDIA H100): K1, the front's f32 count
# scatter and its f32 GEMM's two kernels, and kernels of neither (the
# wire decode's int64 scatter, the g gather, the singlet term, the
# decision's f64 GEMV)
FAST_KERNELS = {
    "void (anonymous namespace)::pair_fast_kernel<8>((anonymous namespace)"
    "::Params)": 0.5,
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<true, float, long>"
    "::operator()<at::native::ReduceAdd>(at::TensorIterator&, long": 0.25,
    "void cutlass::Kernel2<cutlass_80_simt_sgemm_128x32_8x5_nt_align1>"
    "(cutlass_80_simt_sgemm_128x32_8x5_nt_align1::Params)": 0.09375,
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize32x32x8_stage3_warpsize"
    "1x2x1_ffma_aligna4_alignc4_execute_kernel__5x_cublas": 0.03125,
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<true, long, long>"
    "::operator()<at::native::ReduceAdd>(at::TensorIterator&, long": 0.0625,
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, "
    "at::native::_cuda_scatter_gather_internal_kernel<false, "
    "at::native::OpaqueType<4>, long>::operator()": 0.03125,
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "log_kernel_cuda(at::TensorIteratorBase&)": 1.0,
    "void gemv2T_kernel_val<int, int, double, double, double, double, 128, "
    "16, 2, 2, false, false, cublasGemvParamsEx<int": 0.5,
}


def _job(lib, barcodes, phase_s):
    return dict(job=2.0, barcodes=barcodes, phase_s=phase_s, lib=lib)


def _ctx(trace, phase_s=None, jobs=3):
    phase_s = phase_s or {"dispatch": 0.5, "dispatch.front": 0.125,
                          "dispatch.pair": 0.25}
    return dict(jobs=[_job(i % 2, SIZES[i % 2]["cells"], phase_s)
                      for i in range(jobs)],
                sizes=SIZES, config=CFG, trace=trace)


def _read(name, ctx):
    return harness.load_reader(REPO, name)(ctx)


def test_readers_read_their_input():
    """Three jobs on two libraries (1,000 and 2,000 barcodes, then 1,000
    again) of 2 s each, 0.125 s of dispatch.front each, on an 8-donor
    pool on the grid [0, 0.5]: the fast pair search counts 55 channels
    (18 of the separable alpha-0 plane, 37 of the symmetric plane's upper
    triangle with its background) and 9 U rows a slot."""
    trace = dict(busy_s=2.0, window_s=6.5, kernel_s=FAST_KERNELS)
    got = {n: _read(n, _ctx(trace)) for n in READERS}
    per_slot = 55 * 7 + 9 * 18
    least = 0.0
    for lib in (0, 1, 0):
        s = SIZES[lib]
        ops = s["slots"] * per_slot + s["cells"] * 55 * 20
        nbytes = 4 * s["slots"] + 4 * 50000 * 3 * 8
        least += max(ops / 67e12, nbytes / 3.35e12)
    assert got == pytest.approx({
        "fast_pair_roofline": 100.0 * least / 0.5,
        "fast_front.device_ms_per_kbarcode": 1e3 * 0.375 / 4.0,
        "dispatch.front.fraction": 0.375 / 6.0}, rel=1e-12)


def test_fast_pair_roofline_reads_the_tiled_kernels():
    """On pools with V*V*A > 384 the fast pair search is K5' with K4'."""
    kernels = {"void pair_tiled_fast_kernel<16>(dmx::TiledParams<float>)":
               1.5,
               "void extras_fast_kernel<128>(dmx::ExtrasParams<float>)": 0.5,
               "void pair_tiled_exact_kernel<16>(dmx::TiledParams<double>)":
               4.0}
    cfg = dict(CFG, donors=64)
    ctx = dict(_ctx(dict(busy_s=6.0, window_s=7.0, kernel_s=kernels)),
               config=cfg)
    least = sum(roofline.least_s(*roofline_fast.pair_work_of(
        SIZES[j["lib"]], cfg), "f32") for j in ctx["jobs"])
    assert _read("fast_pair_roofline", ctx) == pytest.approx(
        100.0 * least / 2.0, rel=1e-12)


# the tiled fast route's kernels as the card's trace names them, beside
# the exact route's K7' (the exact 64-donor cell's) that the fast pair
# route does not read
TILED_FAST_KERNELS = {
    "void pair_tiled_fast_kernel<16>(dmx::TiledParams<float>)": 1.5,
    "void extras_fast_kernel<128>(dmx::ExtrasParams<float>)": 0.5,
    "void pair_tiled_exact_kernel<16>(dmx::TiledParams<double>)": 4.0,
}


@pytest.mark.parametrize("kernels,dev_s", [
    # K1 and the g gather (0.5 + 0.03125 s); neither the front's f32
    # count scatter nor the wire decode's int64 scatter of the same
    # template, nor the singlet term's log or the decision's GEMV
    (FAST_KERNELS, 0.53125),
    # K5' and K4' with the gather, not K7'
    (dict(TILED_FAST_KERNELS, **{k: v for k, v in FAST_KERNELS.items()
                                 if "<false" in k}), 2.03125),
], ids=["k1", "k5_k4"])
def test_fast_pair_route_reads_its_kernels_and_the_gather(kernels, dev_s):
    """Three jobs of 1,000, 2,000 and 1,000 barcodes: the fast pair
    route's device ms per 1,000 barcodes counts the pair search's kernels
    and the g gather's kernel, and no other kernel."""
    trace = dict(busy_s=6.0, window_s=7.0, kernel_s=kernels)
    assert _read(ROUTE, _ctx(trace)) == pytest.approx(1e3 * dev_s / 4.0,
                                                      rel=1e-12)


def test_fast_pair_route_reads_none_without_its_input():
    """No trace, a trace of none of its kernels (the CPU, or an exact-mode
    window, whose K7' and f64 pair kernels it does not read), no jobs:
    None, never 0 and never an error."""
    bare = dict(busy_s=0.0, window_s=1.0, kernel_s={})
    exact = dict(busy_s=1.0, window_s=2.0, kernel_s={
        "void pair_exact_kernel<8, 2>(double*)": 0.5,
        "void pair_tiled_exact_kernel<16>(dmx::TiledParams<double>)": 1.0,
        "void extras_exact_kernel<128>(dmx::ExtrasParams<double>)": 0.5,
        "void front_exact_kernel<true>(double const*, int)": 0.25})
    for ctx in (_ctx(None), _ctx(bare), _ctx(exact),
                _ctx(dict(bare, kernel_s=FAST_KERNELS), jobs=0)):
        assert _read(ROUTE, ctx) is None


def test_readers_read_none_without_their_input():
    """No trace (an untraced run), a trace with none of the fast route's
    kernels (the CPU, or an exact-mode window), no jobs, and job records
    without the dispatch.front key (a program before its span): None,
    never 0 and never an error."""
    bare = dict(busy_s=0.0, window_s=1.0, kernel_s={})
    exact = dict(busy_s=1.0, window_s=2.0, kernel_s={
        "void pair_exact_kernel<8, 2>(double*)": 0.5,
        "void front_exact_kernel<true>(double const*, int)": 0.25})
    for name in READERS[:2]:
        for ctx in (_ctx(None), _ctx(bare), _ctx(exact),
                    _ctx(dict(bare, kernel_s=FAST_KERNELS), jobs=0)):
            assert _read(name, ctx) is None, name
    parent = {"dispatch": 0.5, "dispatch.pair": 0.25}
    for ctx in (_ctx(None, jobs=0), _ctx(None, phase_s=parent)):
        assert _read("dispatch.front.fraction", ctx) is None


@pytest.mark.parametrize("name,route", [
    ("kang8_a2_fast", "kernels K1 ("),
    ("kang64_a2_fast", "kernels K5' + K4' (")])
def test_fast_pair_work_counts_the_engines_real_slots(monkeypatch, name,
                                                      route):
    """The fast pair search's work is counted over the covered (cell,
    SNP) slots the engine's blocks hold (their unmasked slots as the fast
    block step decodes them), whatever the blocking, and not over the
    padded slot axis the blocks give the kernels: on the 8-donor pool
    (K1) and the 64-donor pool (the tiled K5' + K4')."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from demuxlet_tpu_torch.models import engine as TE

    with open(os.path.join(REPO, "portbench", "configs",
                           name + ".json")) as fh:
        cfg = dict(json.load(fh), snps=2000)
    with open(os.path.join(REPO, "portbench", "traffic",
                           "unfiltered.json")) as fh:
        traffic = dict(json.load(fh), cells=40, empty=24)
    traffic["cell_coverage"] = dict(median=40, sigma=0.6, clip=[5, 200])
    gt, gps = generator.pool_gps(cfg, 21, CPU)
    lib = generator.make_library(cfg, traffic, gt, 21, 0, CPU)
    real, decode = [], TE.decode

    def spy(bufs, meta):
        parts = decode(bufs, meta)
        real.append((int(parts.msk.sum()), parts.msk.numel()))
        return parts

    monkeypatch.setattr(TE, "decode", spy)
    works, padded = [], []
    for block in (48, 64):  # 64 barcodes: 2 blocks of 48 cells, 1 of 64
        scl = CsrPileup(lib.sample_ids, lib.nsnps, lib.barcodes, lib.totl,
                        lib.pass_, lib.uniq, lib.cell_ptr, lib.obs_snp,
                        lib.obs_allele, lib.obs_bq)
        eng = TE.DemuxEngine(gps, cfg["grid_alpha"], cell_block=block,
                             mode="fast", device=CPU)
        real.clear()
        eng.run_compact(scl, cfg["doublet_prior"])
        assert eng.route.startswith(route)
        assert sum(r for r, _ in real) == lib.n_slots
        padded.append(sum(p for _, p in real))
        sizes = dict(cells=lib.n_barcodes, slots=sum(r for r, _ in real),
                     obs_real=lib.n_obs_real)
        works.append(roofline_fast.pair_work_of(sizes, cfg))
    assert padded[0] != padded[1]  # the engine's padded slots move
    assert works[0] == works[1]  # the work counted does not
    assert works[0] == roofline_fast.pair_work_of(
        dict(cells=lib.n_barcodes, slots=lib.n_slots), cfg)
    assert np.all(np.asarray(works[0]) > 0)


def test_fast_metrics_in_the_benchmark():
    """The fast route's metrics: per-layer entries after the accepted
    ones (and before the fast pair route's device time), with their
    units, sources and layers (names the accepted entries use), each with
    a reader; the two device metrics in the two fast cells alone, the
    front's share of dispatch in every cell. The 8-donor fast cell
    reports them, the fast pair route's device time and the accepted
    metrics of the host layers it shares with kang8_a2.cells, and no
    metric of the exact route."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = [w["name"] for w in bench["workloads"]]
    assert cells[-len(NEW_CELLS) - 1:] == ["kang8_a2_fast.cells"] + NEW_CELLS
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert [m["name"] for m in bench["per_layer"]][-4:] == list(READERS) + [
        ROUTE]
    old_layers = {m["layer"] for m in bench["per_layer"][:-4]}
    want = {"fast_pair_roofline": ("%", "higher", "device_trace"),
            "fast_front.device_ms_per_kbarcode": (
                "ms/kbarcode", "lower", "device_trace"),
            "dispatch.front.fraction": (
                "fraction", "lower", "program_counter")}
    for name in READERS:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"]) == want[name], name
        assert m["layer"] in old_layers and m["moves"] == "barcodes_per_s"
        assert m["workloads"] == (cells if name == "dispatch.front.fraction"
                                  else FAST_CELLS), name
        assert os.path.exists(os.path.join(REPO, "portbench", "metrics",
                                           name + ".py"))
    cell, cfg, traffic, e2e, per_layer = harness.load_cell(
        REPO, "kang8_a2_fast.cells")
    assert cell["chips"] == 1 and cell["traffic"] == "cells"
    assert {m["name"] for m in e2e} == {"barcodes_per_s", "peak_device_gib",
                                        "setup_s"}
    assert {m["name"] for m in per_layer} == set(READERS + HOST_METRICS
                                                 + (ROUTE,))
    exact_names = {m["name"] for m in harness.load_cell(
        REPO, "kang8_a2.cells")[4]}
    assert set(HOST_METRICS) <= exact_names
    _, exact_cfg, exact_traffic, _, _ = harness.load_cell(
        REPO, "kang8_a2.cells")
    assert traffic == exact_traffic
    # the exact cell's libraries: the generator reads these keys alone
    for key in ("snps", "donors", "genotype_weights", "geno_error",
                "grid_alpha", "cap_bq", "cell_block", "doublet_prior",
                "field"):
        assert cfg[key] == exact_cfg[key], key
    assert (cfg["mode"], exact_cfg["mode"]) == ("fast", "exact")
    assert cfg["reduced"] == []


def test_traced_fast_run_reads_the_host_metrics(tmp_path):
    """A traced run of the benchmark's tiny CPU cell in fast mode (the
    fast configuration's mode and limits): correct,
    and every metric the fast cell reports that reads the program's spans
    and counters or the host's clock (not the card's trace) reads above 0,
    dispatch.front and dispatch.pair within dispatch."""
    names = [n for n in READERS + HOST_METRICS if n not in (
        "fast_pair_roofline", "fast_front.device_ms_per_kbarcode",
        "device.idle_share")]
    # a process of its own: the run refuses to count where JAX is loaded
    code = (
        "import sys, json, torch\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'portbench', 'tests')!r})\n"
        "from portbench_tiny import run_tiny, tiny_root\n"
        "torch.set_num_threads(2)\n"
        f"root = tiny_root({str(tmp_path)!r})\n"
        "path = root + '/portbench/configs/tiny8.json'\n"
        "fast = json.load(open(root + '/portbench/configs/"
        "kang8_a2_fast.json'))\n"
        "cfg = dict(json.load(open(path)), mode=fast['mode'],\n"
        "           limits=fast['limits'])\n"
        "json.dump(cfg, open(path, 'w'))\n"
        "rc, res, err = run_tiny(root, seed=2 ** 31 + 9, traced=True)\n"
        "print(json.dumps([rc, res, err]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc, res, err = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rc == 0, err
    assert res["correct"] is True, err
    got = {n: res["metrics"][n]["value"] for n in names}
    assert all(v > 0 for v in got.values()), got
    assert (got["dispatch.front.fraction"] + got["dispatch.pair.fraction"]
            <= got["dispatch.fraction"])


def test_new_cells_in_the_benchmark():
    """The 64-donor fast cell and the 14-donor raw lane: one chip each,
    on their configurations and the accepted traffic, after the accepted
    cells; the fast configuration is kang64_a2 with mode fast and its own
    limits, nothing cut. The fast cell reports the fast route's device
    metrics, the fast pair route's device time and the pool metrics the
    exact 64-donor cell reports but the exact route's, and the idle share;
    the raw lane every metric whose list holds both kang8_a2.unfiltered
    and onek1k14_a2.cells, and the tiled roofline. Each list takes the
    new cells at its end."""
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    for name, config, traffic in (
            ("kang64_a2_fast.cells", "kang64_a2_fast", "cells"),
            ("onek1k14_a2.unfiltered", "onek1k14_a2", "unfiltered")):
        w = cells[name]
        assert (w["config"], w["traffic"], w["chips"]) == (config, traffic,
                                                           1)
    entry = next(c for c in bench["configs"]
                 if c["name"] == "kang64_a2_fast")
    assert entry["file"] == "portbench/configs/kang64_a2_fast.json"
    assert entry["reduced"] == []
    _, cfg, _, e2e, per_layer = harness.load_cell(REPO,
                                                  "kang64_a2_fast.cells")
    _, exact_cfg, _, _, exact_layer = harness.load_cell(REPO,
                                                        "kang64_a2.cells")
    differ = {k for k in set(cfg) | set(exact_cfg)
              if cfg.get(k) != exact_cfg.get(k)}
    assert differ == {"name", "source", "mode", "assumed", "limits"}
    assert (cfg["mode"], exact_cfg["mode"]) == ("fast", "exact")
    assert set(cfg["limits"]) == {"rows_gap", "render_lines_off"}
    assert {m["name"] for m in e2e} == {"barcodes_per_s", "peak_device_gib",
                                        "setup_s"}
    exact_only = {"pair_route.device_ms_per_kbarcode", "tiled_pair_roofline"}
    assert {m["name"] for m in per_layer} == (
        {m["name"] for m in exact_layer} - exact_only) | {
            "fast_pair_roofline", "fast_front.device_ms_per_kbarcode",
            ROUTE, "device.idle_share"}
    for m in bench["per_layer"]:
        wl = m["workloads"]
        raw = ("kang8_a2.unfiltered" in wl and "onek1k14_a2.cells" in wl
               or m["name"] == "tiled_pair_roofline")
        assert ("onek1k14_a2.unfiltered" in wl) == raw, m["name"]
        new = [c for c in wl if c in NEW_CELLS]
        assert wl[len(wl) - len(new):] == new, m["name"]
    for name in ("onek1k14_a2.unfiltered", "kang64_a2_fast.cells"):
        for m in harness.load_cell(REPO, name)[4]:
            assert os.path.exists(os.path.join(
                REPO, "portbench", "metrics", m["name"] + ".py"))
