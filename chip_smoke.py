#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

Drives the port's two device paths, fast-mode and exact-mode (the CLI
default) ``DemuxEngine.run_compact`` and the CLI, at the full width of the
repo's realistic configuration (V=8 donors, the 5-point alpha grid, 50,000
SNPs, ~1,000 covered SNPs per cell, --cell-block 2048), after building
every kernel of those paths from the sources in this checkout and holding
each against its plain PyTorch version on the card. Phases, one line each:

  1. environment: torch/CUDA versions, the card's name and power limit;
  2. nvcc build of every csrc/*.cu, one nvcc each, all started together
     (seconds per kernel);
  3. K1 against pair_llks_plain at the main-path shapes (max relative
     error, scale max(1, |x|), limit 2e-5; median ms of 20 launches each);
  4. fast run_compact on a synthetic 20,480-cell pileup (10 blocks of
     2048), wire v2: K1 launch count == blocks, barcodes/s and phase
     seconds, and the first 2 and the last (deepest) block, with their
     slot pads S and lanes U, again with the plain pair search on the card;
  5. the CLI (--mode fast) on a BAM/VCF from tests/fixtures.py: its .best
     calls equal the host-oracle --mode parity calls;
  6. K2' (front_exact) and K3' (pair_exact) against their plain versions
     at the main-path shapes (K2': t and gl within 1e-12 relative; K3':
     LLKs within 1e-9 absolute; median ms of 20 launches each);
  7. exact run_compact on the same pileup: K2' and K3' launched once per
     block, barcodes/s and phase seconds, the first 2 and the last
     (deepest) block again through the plain versions on the card (floats
     within 1e-9 absolute, integer fields equal except counted near ties);
  8. the CLI with no --mode (exact) on the same BAM/VCF: .single and
     .sing2 byte-identical to --mode parity, .best equal after
     canonicalize_best;
  9. per mode, one more run_compact on the pileup (rate, phase seconds,
     peak device memory) and one under torch.profiler: the device's busy
     ms and idle share, the top ops by device ms, and the port's kernels'
     ms per block slot pad.

Then a JSON line of per-kernel numbers and, last, the ok line. Any failure
exits non-zero before the ok line. With no CUDA device it exits 1 at once.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# the port must run without JAX: make any import of it fail loudly
sys.modules["jax"] = None

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

TOL = 2e-5  # fast-mode contract (tests/test_pallas.py): relative, scale max(1,|x|)
EXACT_TOL = 1e-9  # exact-mode contract (tests/test_engine.py): absolute
FRONT_TOL = 1e-12  # K2' vs plain: the same sums, the exp's last bits differ
V, NSNPS, S_PER_CELL, N_CELLS, CELL_BLOCK = 8, 50_000, 1000, 20_480, 2048
GRID = [float(a) for a in np.linspace(0.0, 0.5, 5)]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, **kv}), flush=True)


def rel_err(x, ref) -> float:
    x, ref = x.double(), ref.double()
    return float(((x - ref).abs() / ref.abs().clamp(min=1.0)).max())


def median_ms(fn, n=20) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def pair_inputs(rng, B, S, grid, dev):
    """Main-path K1 inputs: t from real LUT rows and 1-3 observations per
    slot, dirichlet genotype posteriors, ~20% padded (neutral) slots."""
    from demuxlet_tpu.ops import luts
    from demuxlet_tpu_torch.ops.pair import dedup_channels, norm_t

    cols, expand = dedup_channels(grid)
    w = luts.pair_lut(grid, 40)[:, list(cols)].astype(np.float32)
    codes = rng.choice(np.r_[23, 37, 41 + 23, 41 + 37], size=(B, S, 3))
    nobs = rng.integers(1, 4, size=(B, S))
    pad = rng.random((B, S)) < 0.2
    lograw = np.zeros((B, S, len(cols)), np.float32)
    for u in range(3):
        lograw += np.where(((nobs > u) & ~pad)[..., None], w[codes[..., u]], 0)
    g = rng.dirichlet(np.ones(3), size=(B, S, V)).astype(np.float32)
    g[pad] = np.array([1.0, 0.0, 0.0], np.float32)
    t = norm_t(torch.from_numpy(np.ascontiguousarray(
        lograw.transpose(2, 0, 1))).to(dev), 0).contiguous()
    gps_t = torch.from_numpy(np.ascontiguousarray(
        g.transpose(2, 3, 0, 1).reshape(3 * V, B, S))).to(dev)
    return t, gps_t, expand


def synth_pileup(rng, n_cells):
    """Droplet-realistic CSR pileup (the repo's realistic e2e profile):
    lognormal per-cell coverage around S_PER_CELL, SNPs in per-gene runs
    with zipf gene popularity, UMIs/slot 1 + Poisson(0.15) with rare
    PCR-hot slots, BQ binned to {23, 37}."""
    from demuxlet_tpu.host.csr import CsrPileup

    gene_len = 25
    n_genes = NSNPS // gene_len
    pop = 1.0 / np.arange(1, n_genes + 1) ** 0.9
    cdf = np.cumsum(pop / pop.sum())
    gene_perm = rng.permutation(n_genes)
    s_c = np.clip(rng.lognormal(np.log(S_PER_CELL), 0.6, size=n_cells),
                  40, 6 * S_PER_CELL).astype(np.int64)
    ng = np.maximum(s_c // 12, 1)
    tot = int(ng.sum())
    gene = gene_perm[np.searchsorted(cdf, rng.random(tot)).clip(0, n_genes - 1)]
    start = rng.integers(0, gene_len - 5, size=tot)
    run = np.minimum(rng.integers(6, 19, size=tot), gene_len - start)
    first = np.repeat(np.cumsum(run) - run, run)
    snps = np.repeat(gene * gene_len + start, run) + np.arange(run.sum()) - first
    cells = np.repeat(np.repeat(np.arange(n_cells), ng), run)
    occ = 1 + rng.poisson(0.15, size=len(snps))
    hot = rng.random(len(snps)) < 5e-4
    occ[hot] += rng.integers(4, 20, size=int(hot.sum()))
    obs_cell = np.repeat(cells, occ)
    obs_snp = np.repeat(snps, occ)
    nobs = len(obs_snp)
    obs_allele = rng.integers(0, 2, size=nobs).astype(np.uint8)
    obs_bq = np.where(rng.random(nobs) < 0.85, 37, 23).astype(np.uint8)
    totl = np.bincount(obs_cell, minlength=n_cells).astype(np.int64)
    return CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], NSNPS,
        ["BC%06d" % i for i in range(n_cells)], totl, totl, totl,
        obs_cell, obs_snp.astype(np.int64), obs_allele, obs_bq,
    )


def abs_err(x, ref) -> float:
    return float((x.double() - ref.double()).abs().max())


def compare_rows(got, ref, nv, na, tol, absolute=False):
    """Engine rows vs plain-version rows of the same cells. Float fields
    within tol (relative with scale max(1, |x|), or absolute); integer
    fields equal unless their competing values lie within tol (counted as
    near ties). Returns (max err, near ties)."""
    from demuxlet_tpu_torch.models import decision as D

    err_fn = abs_err if absolute else rel_err
    scale = (lambda x: 1.0) if absolute else (
        lambda x: np.maximum(1.0, np.abs(x)))
    gl, g0, gc = D.unpack_block(got, nv, na)
    rl, r0, rc = D.unpack_block(ref, nv, na)
    err = max(err_fn(torch.from_numpy(gl), torch.from_numpy(rl)),
              err_fn(torch.from_numpy(g0), torch.from_numpy(r0)))
    for k in ("sing_col", "llk_00", "max_llk", "max_sing2", "pair_llk12"):
        err = max(err, err_fn(torch.from_numpy(np.asarray(gc[k])),
                              torch.from_numpy(np.asarray(rc[k]))))
    ties = np.zeros(len(got), bool)
    rows = np.arange(len(got))
    sc = np.asarray(rc["sing_col"])
    for k in ("i_sing1", "i_sing2"):
        a, b = gc[k].astype(np.int64), rc[k].astype(np.int64)
        bad = a != b
        close = (np.abs(sc[rows, a] - sc[rows, b])
                 <= tol * scale(sc[rows, b]))
        if (bad & ~close).any():
            fail(f"{k} differs beyond a near tie in "
                 f"{int((bad & ~close).sum())} cells")
        ties |= bad
    bad = gc["best_flat"] != rc["best_flat"]
    close = (np.abs(gc["pair_llk12"] - rc["pair_llk12"])
             <= tol * scale(rc["pair_llk12"]))
    if (bad & ~close).any():
        fail(f"best_flat differs beyond a near tie in "
             f"{int((bad & ~close).sum())} cells")
    ties |= bad
    return err, int(ties.sum())


def exact_inputs(rng, B, S, grid, dev):
    """Main-path K2' inputs: the unnarrowed cap-40 exact tables, 1-3
    observations per slot from real LUT rows (the rest of U=3 lanes none),
    ~20% padded slots; and K3''s genotype rows: dirichlet posteriors,
    their f64 mean as the background rows, neutral rows on padded slots."""
    from demuxlet_tpu_torch.models.engine import exact_tables_from_numpy

    tab = exact_tables_from_numpy(np.full((1, V, 3), 1 / 3), grid, 40, None,
                                  dev)
    codes = rng.choice(np.r_[23, 37, 41 + 23, 41 + 37], size=(B, S, 3))
    nobs = rng.integers(1, 4, size=(B, S))
    pad = rng.random((B, S)) < 0.2
    codes[(np.arange(3) >= nobs[..., None]) | pad[..., None]] = 255
    g = rng.dirichlet(np.ones(3), size=(B, S, V))
    g = np.concatenate([g, g.mean(axis=2, keepdims=True)], axis=2)
    g[pad] = np.array([1.0, 0.0, 0.0])
    g = torch.from_numpy(np.ascontiguousarray(
        g.transpose(2, 3, 0, 1).reshape(3 * V + 3, B, S))).to(dev)
    codes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    return tab, codes, torch.from_numpy(~pad).to(dev), g


def cli_case(tmp):
    """A BAM/VCF from tests/fixtures.py: 300 cells, V=8 samples."""
    import random

    from fixtures import random_workload, write_bam, write_vcf

    contigs, names, variants, reads, _truth = random_workload(
        random.Random(7), n_cells=300, n_snps=200, n_samples=V,
        reads_per_cell=80)
    vcf = write_vcf(os.path.join(tmp, "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(os.path.join(tmp, "w.bam"), contigs, reads)
    return ["--sam", bam, "--vcf", vcf, "--field", "GT"]


def run_cli(base, tmp, name, mode=None):
    """One CLI run into tmp/name (no --mode: the parser default)."""
    from demuxlet_tpu_torch import cli

    out = os.path.join(tmp, name)
    argv = base + ["--out", out] + ([] if mode is None else ["--mode", mode])
    if cli.main(argv) != 0:
        fail(f"CLI {name} returned non-zero")
    files = {}
    for ext in (".single", ".sing2", ".best"):
        with open(out + ext) as fh:
            files[ext] = fh.read().splitlines()
    return files


def engine_vs_plain(eng, csr, llks, llk0s, comp, blocks, pads, exact, dev):
    """The first 2 blocks of an engine run and its last (blocks are
    coverage-sorted: the shallowest and the deepest) again, through the
    plain versions of the path's kernels on the same device; compare_rows
    of the engine's rows against them. Returns (max err, near ties,
    [{block, S, U, cells}])."""
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import _h2d
    from demuxlet_tpu_torch.ops.front_exact import front_exact_plain
    from demuxlet_tpu_torch.ops.pair import pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain

    cfg = eng._wire_cfg_for(csr)
    A = len(eng.grid_alpha)
    dbl_w = torch.as_tensor(D.doublet_weights(V, eng.grid_alpha, 0.5),
                            dtype=torch.float64, device=dev)
    dbl_msk = torch.as_tensor(D.doublet_mask(V, A), device=dev)
    kw = dict(a0_sep=True, sym_a=eng.grid_alpha.index(0.5))
    got, ref, checked = [], [], []
    for i in sorted({0, 1, len(blocks) - 1} & set(range(len(blocks)))):
        cells = blocks[i]
        buf, meta, _ = eng._prep_codes_blk(csr, cells,
                                           pads[i] if pads else None)
        # the v2 wire meta: ("w2", S, U, ...), U the full-lane count
        checked.append(dict(block=i, S=meta[1], U=meta[2], cells=len(cells)))
        if exact:
            rows = D.compact_step_body_exact(
                _h2d(buf, dev), None, None, eng._exact_tables(cfg), dbl_w,
                dbl_msk, A, V, 0.5, wire=meta, front_fn=front_exact_plain,
                pair_fn=pair_exact_plain, **kw)
        else:
            tab = eng._fast_tables(cfg)
            rows = D.compact_step_body(
                _h2d(buf, dev), None, None, tab.gps, tab.gp0, tab.w_ext,
                tab.logf_ext, dbl_w, dbl_msk, A, V, 0.5, expand=tab.expand,
                wire=meta, pair_fn=pair_llks_plain, **kw)
        ref.append(rows.cpu().numpy()[: len(cells)])
        c = D.take(comp, np.asarray(cells))
        got.append(np.concatenate(
            [c.sing_col, c.llk_00]
            + [getattr(c, k).astype(np.float64)[:, None] for k in D._PACK_KEYS]
            + [llks[cells], llk0s[cells][:, None]], axis=1))
    tol = EXACT_TOL if exact else TOL
    err, ties = compare_rows(np.concatenate(got), np.concatenate(ref), V, A,
                             tol, absolute=exact)
    return err, ties, checked


def drive_engine(csr, gps, mode, dev, kernels):
    """One run_compact of the given mode on csr, with every launch count
    of the path's kernels set to 0 just before and read just after;
    checks the counts (once per block) and the outputs' shapes, and the
    first 2 and the last (deepest) block against the plain versions.
    Returns (phase fields, {kernel module: launches})."""
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    # warm-up on another pileup: builds the native packer, inits cuBLAS
    DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, mode=mode,
                device=dev).run_compact(
        synth_pileup(np.random.default_rng(2), CELL_BLOCK), 0.5)
    torch.cuda.synchronize()
    eng = DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, mode=mode, device=dev)
    for k in kernels:
        k.reset_launches()
    t0 = time.monotonic()
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    launches = {k: k.launches for k in kernels}
    blocks, pads = eng._blocks(csr.nbcs, csr)
    if len(blocks) != N_CELLS // CELL_BLOCK or any(
            n != len(blocks) for n in launches.values()):
        named = [(k.__name__, n) for k, n in launches.items()]
        fail(f"{mode}: launches {named} for {len(blocks)} blocks")
    if not (np.isfinite(llks).all() and np.isfinite(llk0s).all()
            and np.isfinite(comp.pair_llk12).all()
            and llks.shape == (N_CELLS, V)):
        fail(f"{mode} engine outputs are not finite or have the wrong shape")
    if eng._wire_cfg_for(csr) is None:
        fail(f"the {mode} engine run did not use wire v2")
    exact = mode == "exact"
    err, ties, checked = engine_vs_plain(eng, csr, llks, llk0s, comp, blocks,
                                         pads, exact, dev)
    tol = EXACT_TOL if exact else TOL
    if not err <= tol:
        fail(f"{mode} engine vs plain: max error {err} > {tol}")
    fields = dict(cells=N_CELLS, blocks=len(blocks), wire="v2",
                  barcodes_per_s=N_CELLS / wall, seconds=wall,
                  phase_s=eng.phase_s, h2d_bytes=eng.h2d_bytes,
                  plain_check_blocks=checked, near_tie_cells=ties)
    fields["plain_max_abs_err" if exact else "plain_max_rel_err"] = err
    return fields, launches


# the port's own kernels, by the name CUPTI records for them
OWN_KERNELS = {"front_exact_kernel": "K2'", "pair_exact_kernel": "K3'",
               "pair_fast_kernel": "K1"}


def trace_summary(path, pads):
    """Device time of an exported torch.profiler trace, summed from its
    kernel, memcpy and memset events: busy ms (the union of their
    intervals), ms and count per launching aten op (or per kernel, for the
    port's own kernels and launches without an op), and the port's kernels'
    ms per block, keyed by the block's slot pad S."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    op_of = {e["args"].get("External id"): e["name"]
             for e in ev if e.get("cat") == "cpu_op"}
    devs = sorted((e for e in ev
                   if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")),
                  key=lambda e: e["ts"])
    busy, end, by_op, per_block = 0.0, float("-inf"), {}, {}
    for e in devs:
        a, b = e["ts"], e["ts"] + e["dur"]
        if b > end:
            busy += b - max(a, end)
            end = b
        own = next((v for k, v in OWN_KERNELS.items() if k in e["name"]),
                   None)
        name = own or (e["name"] if e["cat"] != "kernel" else
                       op_of.get(e["args"].get("External id"), e["name"][:60]))
        n, ms = by_op.get(name, (0, 0.0))
        by_op[name] = (n + 1, ms + e["dur"] / 1e3)
        if own:
            per_block.setdefault(own, []).append(e["dur"] / 1e3)
    by_s = {}
    for own, times in per_block.items():
        if len(times) != len(pads):
            fail(f"trace: {len(times)} {own} launches for {len(pads)} blocks")
        acc = {}
        for s, ms in zip(pads, times):
            acc.setdefault(s, []).append(ms)
        by_s[own] = {str(s): sum(v) / len(v) for s, v in sorted(acc.items())}
    top = sorted(by_op.items(), key=lambda kv: -kv[1][1])[:10]
    return busy / 1e3, [[k, n, ms] for k, (n, ms) in top], by_s


def profile_engine(csr, gps, mode, dev):
    """On a pileup whose wire config is already cached, one
    untraced run_compact (wall, rate, phase seconds, peak device memory)
    and one under torch.profiler, whose exported trace gives the device's
    busy time, its idle share of the untraced wall, the top ops and the
    port's kernels' ms per block slot pad."""
    from torch.profiler import ProfilerActivity, profile

    from demuxlet_tpu_torch.models.engine import DemuxEngine

    eng = DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, mode=mode, device=dev)
    eng.run_compact(csr, 0.5)  # the engine's tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    phase_s = dict(eng.phase_s)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_compact(csr, 0.5)
        torch.cuda.synchronize()
    blocks, pads = eng._blocks(csr.nbcs, csr)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy, top, by_s = trace_summary(path, pads or [None] * len(blocks))
    return dict(mode=mode, cells=csr.nbcs, wall_s=wall,
                barcodes_per_s=csr.nbcs / wall, phase_s=phase_s,
                peak_device_gb=peak / 1e9, device_busy_ms=busy,
                idle_share=1.0 - busy / 1e3 / wall, top_device_ms=top,
                kernel_ms_by_S=by_s)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.kernels import pair_fast
    from demuxlet_tpu_torch.ops.front_exact import (
        front_exact,
        front_exact_plain,
    )
    from demuxlet_tpu_torch.ops.pair import pair_llks, pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact, pair_exact_plain
    from demuxlet_tpu_torch.utils.device import resolve_device
    from parity_utils import canonicalize_best, canonicalize_best_line

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    phase("env", python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), nvidia_smi=card)

    dev = resolve_device("auto")
    for name, (lib_path, secs) in kbuild.build_all().items():
        phase("build", kernel=name, seconds=secs,
              library=os.path.relpath(lib_path, HERE))

    # ---- 3. K1 against its plain version at the main path's shapes
    rng = np.random.default_rng(0)
    k1 = {"max_rel": 0.0, "max_abs": 0.0}
    for name, B, S, grid in (
        ("main", 2048, 1024, GRID),
        ("default_grid", 2048, 1024, [0.0, 0.5]),
        ("ragged", 40, 384, GRID),
    ):
        A = len(grid)
        t, gps_t, expand = pair_inputs(rng, B, S, grid, dev)
        args = (t, gps_t, V, A, grid[0] == 0.0, grid.index(0.5), expand)
        ab, z0 = pair_llks(*args)
        torch.cuda.synchronize()
        pab, pz0 = pair_llks_plain(*args)
        err = max(rel_err(ab, pab), rel_err(z0, pz0))
        aerr = float(max((ab - pab).abs().max(), (z0 - pz0).abs().max()))
        if not (np.isfinite(err) and err <= TOL):
            fail(f"K1 {name}: max relative error {err} > {TOL}")
        ms = median_ms(lambda: pair_llks(*args))
        plain_ms = median_ms(lambda: pair_llks_plain(*args))
        phase("k1_vs_plain", case=name, B=B, S=S, V=V, A=A, C=t.shape[0],
              max_rel_err=err, max_abs_err=aerr, tol=TOL, ms=ms,
              plain_ms=plain_ms)
        k1["max_rel"] = max(k1["max_rel"], err)
        k1["max_abs"] = max(k1["max_abs"], aerr)
        if name == "main":
            k1["ms"], k1["plain_ms"] = ms, plain_ms
        del t, gps_t, ab, z0, pab, pz0
    torch.cuda.empty_cache()

    # ---- 4. the fast engine's main path
    rng = np.random.default_rng(1)
    t0 = time.monotonic()
    csr = synth_pileup(rng, N_CELLS)
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, V))
    t_gen = time.monotonic() - t0
    fields, counts = drive_engine(csr, gps, "fast", dev, [pair_fast])
    launches = counts[pair_fast]
    phase("engine", mode="fast", k1_launches=launches, gen_s=t_gen,
          card=card, **fields)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5. the CLI (fast) against the host oracle
        base = cli_case(tmp)
        pair_fast.reset_launches()
        fast = run_cli(base, tmp, "fast", "fast")
        cli_launches = pair_fast.launches
        parity = run_cli(base, tmp, "parity", "parity")
        calls = [[canonicalize_best_line(l).split("\t")[5] for l in f[1:]]
                 for f in (fast[".best"], parity[".best"])]
        if not calls[0] or calls[0] != calls[1] or cli_launches < 1:
            fail(f"CLI fast calls differ from parity ({len(calls[0])} rows, "
                 f"{sum(a != b for a, b in zip(*calls))} differ, "
                 f"{cli_launches} K1 launches)")
        phase("cli", mode="fast", cells=len(calls[0]), samples=V,
              best_equal_parity=True, k1_launches=cli_launches)

        # ---- 6. K2' and K3' against their plain versions
        rng = np.random.default_rng(3)
        kx = {k: {"max_abs": 0.0, "max_rel": 0.0} for k in ("k2", "k3")}
        for name, B, S, grid in (
            ("main", 2048, 1024, GRID),
            ("default_grid", 2048, 1024, [0.0, 0.5]),
            ("ragged", 40, 384, GRID),
        ):
            A = len(grid)
            tab, codes, msk, g = exact_inputs(rng, B, S, grid, dev)
            fargs = (codes, tab.lut, msk, tab.cmask, tab.gsel)
            t, gl = front_exact(*fargs)
            torch.cuda.synchronize()
            pt, pgl = front_exact_plain(*fargs)
            aerr = max(abs_err(t, pt), abs_err(gl, pgl))
            err = max(
                float(((x - y).abs() / y.abs().clamp(min=1e-300)).max())
                for x, y in ((t, pt), (gl, pgl)))
            if not err <= FRONT_TOL:
                fail(f"K2' {name}: max relative error {err} > {FRONT_TOL}")
            ms = median_ms(lambda: front_exact(*fargs))
            plain_ms = median_ms(lambda: front_exact_plain(*fargs))
            phase("k2_vs_plain", case=name, B=B, S=S, U=codes.shape[2],
                  R=tab.lut.shape[0], C=tab.lut.shape[1], max_rel_err=err,
                  max_abs_err=aerr, tol=FRONT_TOL, ms=ms, plain_ms=plain_ms)
            kx["k2"]["max_abs"] = max(kx["k2"]["max_abs"], aerr)
            kx["k2"]["max_rel"] = max(kx["k2"]["max_rel"], err)
            if name == "main":
                kx["k2"]["ms"], kx["k2"]["plain_ms"] = ms, plain_ms
            pargs = (t, g, gl, V, A, grid[0] == 0.0, grid.index(0.5),
                     tab.expand)
            got = pair_exact(*pargs)
            torch.cuda.synchronize()
            want = pair_exact_plain(*pargs)
            aerr = max(abs_err(x, y) for x, y in zip(got, want))
            err = max(rel_err(x, y) for x, y in zip(got, want))
            if not (np.isfinite(aerr) and aerr <= EXACT_TOL):
                fail(f"K3' {name}: max absolute error {aerr} > {EXACT_TOL}")
            ms = median_ms(lambda: pair_exact(*pargs))
            plain_ms = median_ms(lambda: pair_exact_plain(*pargs))
            phase("k3_vs_plain", case=name, B=B, S=S, V=V, A=A,
                  C=t.shape[0], max_abs_err=aerr, max_rel_err=err,
                  tol=EXACT_TOL, ms=ms, plain_ms=plain_ms)
            kx["k3"]["max_abs"] = max(kx["k3"]["max_abs"], aerr)
            kx["k3"]["max_rel"] = max(kx["k3"]["max_rel"], err)
            if name == "main":
                kx["k3"]["ms"], kx["k3"]["plain_ms"] = ms, plain_ms
            del tab, codes, msk, g, t, gl, pt, pgl, got, want
        torch.cuda.empty_cache()

        # ---- 7. the exact engine's main path, on the same pileup
        fields, counts = drive_engine(csr, gps, "exact", dev, [k2, k3])
        phase("engine", mode="exact", k2_launches=counts[k2],
              k3_launches=counts[k3], card=card, **fields)

        # ---- 8. the CLI's default mode (exact) against the host oracle
        k2.reset_launches()
        k3.reset_launches()
        exact = run_cli(base, tmp, "exact")
        cli_counts = (k2.launches, k3.launches)
        for ext in (".single", ".sing2"):
            if exact[ext] != parity[ext]:
                bad = sum(a != b for a, b in zip(exact[ext], parity[ext]))
                fail(f"CLI default-mode {ext} differs from parity: "
                     f"{bad} of {len(parity[ext])} lines")
        if canonicalize_best(exact[".best"]) != canonicalize_best(
                parity[".best"]):
            fail("CLI default-mode .best differs from parity after "
                 "canonicalize_best")
        if min(cli_counts) < 1 or len(exact[".best"]) < 2:
            fail(f"CLI default mode: {len(exact['.best'])} .best lines, "
                 f"K2'/K3' launches {cli_counts}")
        phase("cli", mode="exact (default)", cells=len(exact[".best"]) - 1,
              samples=V, single_sing2_byte_identical=True,
              best_equal_parity=True, k2_launches=cli_counts[0],
              k3_launches=cli_counts[1])

    # ---- 9. where the device time goes, per mode
    for mode in ("exact", "fast"):
        phase("trace", card=card, **profile_engine(csr, gps, mode, dev))

    def row(name, source, replaces, n, k):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": k["max_abs"], "max_rel_err": k["max_rel"],
                "ms": k["ms"], "plain_ms": k["plain_ms"]}

    print(json.dumps({"kernels": [
        row("pair_fast (K1)", "demuxlet_tpu_torch/csrc/pair_fast.cu",
            "demuxlet_tpu/ops/pallas_pair.py:96", launches, k1),
        row("front_exact (K2')", "demuxlet_tpu_torch/csrc/front_exact.cu",
            "demuxlet_tpu/ops/pallas_pair_exact.py:962", counts[k2],
            kx["k2"]),
        row("pair_exact (K3')", "demuxlet_tpu_torch/csrc/pair_exact.cu",
            "demuxlet_tpu/ops/pallas_pair_exact.py:219", counts[k3],
            kx["k3"]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
