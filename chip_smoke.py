#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

Drives the port's device paths, fast-mode and exact-mode (the CLI default)
``DemuxEngine.run_compact`` and the CLI, at the full width of the repo's
realistic configuration (V=8 donors, the 5-point alpha grid, 50,000 SNPs,
~1,000 covered SNPs per cell, --cell-block 2048), and exact mode on a large
pool (V=32 donors on the CLI's default grid [0, 0.5], V*V*A = 2048: the
tiled K7' + K6'), after building every kernel of those paths from the
sources in this checkout and holding each against its plain PyTorch
version on the card. Phases, one line each:

  1. environment: torch/CUDA versions, the card's name and power limit;
  2. nvcc build of every csrc/*.cu, one nvcc each, all started together
     (seconds per kernel; ptxas's registers and spills per instantiation);
  3. K1 against pair_llks_plain at the main-path shapes (max relative
     error, scale max(1, |x|), limit 2e-5; median ms of 20 launches each);
  4. fast run_compact on a synthetic 20,480-cell pileup (10 blocks of
     2048), wire v2: K1 launch count == blocks, barcodes/s and phase
     seconds, and the first 2 and the last (deepest) block, with their
     slot pads S and lanes U, again with the plain pair search on the card;
  5. the CLI (--mode fast) on a BAM/VCF from tests/fixtures.py (150 cells,
     V=8): its .best calls equal the host-oracle --mode parity calls;
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
  9. K7' (pair_tiled_exact) and K6' (extras_exact) against their plain
     versions at B=2048, S=1024 for (V, A) = (32, 5), (32, 2), (20, 2),
     (17, 3) and a ragged B=40/S=384 case (V=7, A=8: one 8-tile): within
     1e-9 absolute; kernel ms (median of CUDA-event timed launches) and
     plain ms;
 10. exact run_compact on the same pileup with V=32 donors on the default
     grid: K2', K7' and K6' launched once per block and K3' never, rate,
     phase seconds, peak device memory, and the first 2 and the deepest
     block through the plain versions (1e-9 absolute, near ties counted);
 11. the CLI with no --mode on a V=16 default-grid BAM/VCF (100 cells,
     V*V*A = 512: K7' + K6') against --mode parity, as in phase 8;
 12. per run (exact and fast at V=8, exact at V=32), one more run_compact
     on the pileup (rate, phase seconds, peak device memory) and one under
     torch.profiler: the device's busy ms and idle share, the top ops by
     device ms, and the port's kernels' ms per block slot pad.

Then a JSON line of per-kernel numbers (with each kernel's bound: the
larger of its operations over the card's peak rate for their type and its
bytes over the memory rate, counted as ``bound`` and ``channel_ops``
say), the card's name and power limit, and, last, the ok line. Any failure
exits non-zero before the ok line. With no CUDA device it exits 1 at once. Nothing of JAX, of the JAX
package or of oracle/ is imported.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# the port runs without JAX and the JAX package: any import of them fails
for _name in ("jax", "demuxlet_tpu", "oracle"):
    sys.modules[_name] = None

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

START = time.monotonic()

TOL = 2e-5  # fast-mode contract (tests/test_pallas.py): relative, scale max(1,|x|)
EXACT_TOL = 1e-9  # exact-mode contract (tests/test_engine.py): absolute
FRONT_TOL = 1e-12  # K2' vs plain: the same sums, the exp's last bits differ
V, NSNPS, S_PER_CELL, N_CELLS, CELL_BLOCK = 8, 50_000, 1000, 20_480, 2048
GRID = [float(a) for a in np.linspace(0.0, 0.5, 5)]
V_LARGE, GRID_LARGE = 32, [0.0, 0.5]  # the large pool: the tiled K7' + K6'

# the bound of a kernel: the larger of its operations over the card's peak
# rate for their type and its bytes (each input read once, each output
# written once) over the memory rate. NVIDIA H100 SXM data sheet: 34 TFLOP/s
# f64 and 67 TFLOP/s f32 outside the tensor cores (which none of these
# kernels can use), 3.35 TB/s HBM3. One log or exp is counted as 20
# operations of its type (its polynomial is about ten FMAs), an FMA as 2.
# A pair or singlet channel's sum over slots of log(inner) needs no log per
# slot: its inner values multiply into a running product (with exponent
# renormalisation, as the TPU's pair kernels did) and take one log per
# channel per cell. So a channel costs its 3-term dot and one multiply per
# slot, and one log per cell.
PEAK_OPS = {"f64": 34e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
LOG_OPS = 20
CHANNEL_OPS = 7  # per slot: a 3-term dot (3 FMAs) and one multiply
ROW_OPS = 18  # one row of U = g_j . t_a: 9 FMAs


def bound(ops, nbytes, kind):
    """(bound_ms, bound_by) of a kernel: the larger of its operations over
    the peak rate of their type and its bytes over the memory rate."""
    t_ops = ops / PEAK_OPS[kind] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def channel_ops(B, S, channels, rows):
    """The operations of ``channels`` log-sum channels and ``rows`` U rows
    per slot over B cells of S slots: a dot and a multiply per channel and
    slot, a U row per slot, and one log per channel and cell."""
    return B * S * (channels * CHANNEL_OPS + rows * ROW_OPS) \
        + B * channels * LOG_OPS


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


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    """One phase line; t_s: seconds since the script started."""
    print(json.dumps({"phase": name, "t_s": time.monotonic() - START, **kv}),
          flush=True)


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


def flat_dirichlet(rng, shape, dev):
    """Flat-Dirichlet draws over axis 1 of ``shape``, f64 on dev:
    normalised Exp(1) variables from a generator seeded by rng."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(1 << 62)))
    e = torch.empty(shape, dtype=torch.float64, device=dev).exponential_(
        generator=gen)
    return e / e.sum(dim=1, keepdim=True)


def neutral_on(pad, g):
    """g (n, 3, B, S) with the neutral row (1, 0, 0) on the padded slots
    pad (B, S), as (3n, B, S) contiguous."""
    one = torch.zeros(3, dtype=g.dtype, device=g.device)
    one[0] = 1
    pad = torch.from_numpy(pad).to(g.device)
    return torch.where(pad, one.view(3, 1, 1), g).reshape(
        -1, *pad.shape).contiguous()


def pair_inputs(rng, B, S, grid, dev):
    """Main-path K1 inputs: t from real LUT rows and 1-3 observations per
    slot, flat-Dirichlet genotype posteriors drawn on the device, ~20%
    padded (neutral) slots."""
    from demuxlet_tpu_torch.ops import luts
    from demuxlet_tpu_torch.ops.pair import dedup_channels, norm_t

    cols, expand = dedup_channels(grid)
    w = luts.pair_lut(grid, 40)[:, list(cols)].astype(np.float32)
    codes = rng.choice(np.r_[23, 37, 41 + 23, 41 + 37], size=(B, S, 3))
    nobs = rng.integers(1, 4, size=(B, S))
    pad = rng.random((B, S)) < 0.2
    lograw = np.zeros((B, S, len(cols)), np.float32)
    for u in range(3):
        lograw += np.where(((nobs > u) & ~pad)[..., None], w[codes[..., u]], 0)
    gps_t = neutral_on(pad, flat_dirichlet(rng, (V, 3, B, S), dev).float())
    t = norm_t(torch.from_numpy(np.ascontiguousarray(
        lograw.transpose(2, 0, 1))).to(dev), 0).contiguous()
    return t, gps_t, expand


def synth_pileup(rng, n_cells):
    """Droplet-realistic CSR pileup (the repo's realistic e2e profile):
    lognormal per-cell coverage around S_PER_CELL, SNPs in per-gene runs
    with zipf gene popularity, UMIs/slot 1 + Poisson(0.15) with rare
    PCR-hot slots, BQ binned to {23, 37}."""
    from demuxlet_tpu_torch.host.csr import CsrPileup

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


def exact_inputs(rng, B, S, grid, dev, nv=V):
    """Main-path K2' inputs: the unnarrowed cap-40 exact tables, 1-3
    observations per slot from real LUT rows (the rest of U=3 lanes none),
    ~20% padded slots; and the pair kernels' genotype rows for nv samples,
    drawn on the device: flat-Dirichlet posteriors, their f64 mean as the
    background rows, neutral rows on padded slots."""
    from demuxlet_tpu_torch.models.engine import exact_tables_from_numpy

    tab = exact_tables_from_numpy(np.full((1, nv, 3), 1 / 3), grid, 40, None,
                                  dev)
    codes = rng.choice(np.r_[23, 37, 41 + 23, 41 + 37], size=(B, S, 3))
    nobs = rng.integers(1, 4, size=(B, S))
    pad = rng.random((B, S)) < 0.2
    codes[(np.arange(3) >= nobs[..., None]) | pad[..., None]] = 255
    g = flat_dirichlet(rng, (nv, 3, B, S), dev)
    g = neutral_on(pad, torch.cat([g, g.mean(dim=0, keepdim=True)]))
    codes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    return tab, codes, torch.from_numpy(~pad).to(dev), g


def cli_case(tmp, n_samples, n_cells, reads_per_cell):
    """A BAM/VCF from tests/fixtures.py (200 SNPs) in tmp."""
    import random

    from demuxlet_tpu_torch.io import bgzf

    # fixtures.py imports BgzfWriter, BGZF_EOF, compress_block and
    # read_block_at by the full name demuxlet_tpu.io.bgzf (its only import
    # of the JAX package on the BAM/VCF path; rans is for CRAM). That name is
    # bound to the port's copy, which the import finds in sys.modules without
    # loading a parent package. tests/test_torch_imports.py runs this
    # function with the JAX package blocked, so a new import there fails on
    # the CPU first.
    sys.modules.setdefault("demuxlet_tpu.io.bgzf", bgzf)
    from fixtures import random_workload, write_bam, write_vcf

    contigs, names, variants, reads, _truth = random_workload(
        random.Random(7), n_cells=n_cells, n_snps=200, n_samples=n_samples,
        reads_per_cell=reads_per_cell)
    vcf = write_vcf(os.path.join(tmp, "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(os.path.join(tmp, "w.bam"), contigs, reads)
    return ["--sam", bam, "--vcf", vcf, "--field", "GT"]


def cli_vs_parity(base, tmp, kernels, absent=(), parity=None):
    """The CLI with no --mode (exact) against --mode parity (the host
    oracle; run here unless its files are given) on one input: .single and
    .sing2 byte-identical, .best equal after canonicalize_best, every
    kernel of ``kernels`` launched and none of ``absent``. Returns (cells,
    {kernel: launches})."""
    from parity_utils import canonicalize_best

    for k in (*kernels, *absent):
        k.reset_launches()
    exact = run_cli(base, tmp, "exact")
    counts = {k: k.launches for k in (*kernels, *absent)}
    if parity is None:
        parity = run_cli(base, tmp, "parity", "parity")
    for ext in (".single", ".sing2"):
        if exact[ext] != parity[ext]:
            bad = sum(a != b for a, b in zip(exact[ext], parity[ext]))
            fail(f"CLI default-mode {ext} differs from parity: "
                 f"{bad} of {len(parity[ext])} lines")
    if canonicalize_best(exact[".best"]) != canonicalize_best(
            parity[".best"]):
        fail("CLI default-mode .best differs from parity after "
             "canonicalize_best")
    named = {k.__name__.rsplit(".", 1)[1]: n for k, n in counts.items()}
    if (min(counts[k] for k in kernels) < 1 or any(counts[k] for k in absent)
            or len(exact[".best"]) < 2):
        fail(f"CLI default mode: {len(exact['.best'])} .best lines, "
             f"launches {named}")
    return len(exact[".best"]) - 1, named


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
    import functools

    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import _h2d
    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.front_exact import front_exact_plain
    from demuxlet_tpu_torch.ops.pair import UNROLL_CAP, pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain

    cfg = eng._wire_cfg_for(csr)
    V, A = eng.nv, len(eng.grid_alpha)
    exact_pair_plain = pair_exact_plain if V * V * A <= UNROLL_CAP else \
        functools.partial(PT.pair_exact_tiled, pair_fn=PT.pair_tiled_plain,
                          extras_fn=PT.extras_plain)
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
                pair_fn=exact_pair_plain, **kw)
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


def drive_engine(csr, gps, mode, dev, kernels, grid=GRID, absent=()):
    """One run_compact of the given mode and grid on csr, scored against
    gps's donors, with every launch count of ``kernels`` (the path's) and
    ``absent`` (kernels the path must not launch) set to 0 just before and
    read just after; checks the counts (once per block, and never), the
    outputs' shapes, and the first 2 and the last (deepest) block against
    the plain versions. Returns (phase fields, {kernel module:
    launches})."""
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    nv = gps.shape[1]
    # warm-up on another pileup: builds the native packer, inits cuBLAS
    DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode,
                device=dev).run_compact(
        synth_pileup(np.random.default_rng(2), CELL_BLOCK), 0.5)
    torch.cuda.synchronize()
    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
    for k in (*kernels, *absent):
        k.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: k.launches for k in (*kernels, *absent)}
    blocks, pads = eng._blocks(csr.nbcs, csr)
    if len(blocks) != N_CELLS // CELL_BLOCK or any(
            launches[k] != len(blocks) for k in kernels) or any(
            launches[k] for k in absent):
        named = [(k.__name__, n) for k, n in launches.items()]
        fail(f"{mode}: launches {named} for {len(blocks)} blocks")
    if not (np.isfinite(llks).all() and np.isfinite(llk0s).all()
            and np.isfinite(comp.pair_llk12).all()
            and llks.shape == (N_CELLS, nv)):
        fail(f"{mode} engine outputs are not finite or have the wrong shape")
    if eng._wire_cfg_for(csr) is None:
        fail(f"the {mode} engine run did not use wire v2")
    exact = mode == "exact"
    err, ties, checked = engine_vs_plain(eng, csr, llks, llk0s, comp, blocks,
                                         pads, exact, dev)
    tol = EXACT_TOL if exact else TOL
    if not err <= tol:
        fail(f"{mode} engine vs plain: max error {err} > {tol}")
    fields = dict(cells=N_CELLS, samples=nv, alphas=len(grid),
                  blocks=len(blocks), wire="v2",
                  barcodes_per_s=N_CELLS / wall, seconds=wall,
                  phase_s=eng.phase_s, h2d_bytes=eng.h2d_bytes,
                  peak_device_gb=peak / 1e9, plain_check_blocks=checked,
                  near_tie_cells=ties)
    fields["plain_max_abs_err" if exact else "plain_max_rel_err"] = err
    return fields, launches


# the port's own kernels, by the name CUPTI records for them
OWN_KERNELS = {"front_exact_kernel": "K2'", "pair_exact_kernel": "K3'",
               "pair_fast_kernel": "K1", "pair_tiled_exact_kernel": "K7'",
               "extras_exact_kernel": "K6'"}


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


def profile_engine(csr, gps, mode, dev, grid=GRID):
    """On a pileup whose wire config is already cached, one
    untraced run_compact (wall, rate, phase seconds, peak device memory)
    and one under torch.profiler, whose exported trace gives the device's
    busy time, its idle share of the untraced wall, the top ops and the
    port's kernels' ms per block slot pad."""
    from torch.profiler import ProfilerActivity, profile

    from demuxlet_tpu_torch.models.engine import DemuxEngine

    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
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
    return dict(mode=mode, samples=gps.shape[1], alphas=len(grid),
                cells=csr.nbcs, wall_s=wall,
                barcodes_per_s=csr.nbcs / wall, phase_s=phase_s,
                peak_device_gb=peak / 1e9, device_busy_ms=busy,
                idle_share=1.0 - busy / 1e3 / wall, top_device_ms=top,
                kernel_ms_by_S=by_s)


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.kernels import extras_exact as k6
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.kernels import pair_fast
    from demuxlet_tpu_torch.kernels import pair_tiled_exact as k7
    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.front_exact import (
        front_exact,
        front_exact_plain,
    )
    from demuxlet_tpu_torch.ops.pair import pair_llks, pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact, pair_exact_plain
    from demuxlet_tpu_torch.utils.device import resolve_device
    from parity_utils import canonicalize_best_line

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
              library=os.path.relpath(lib_path, HERE),
              ptxas=kbuild.ptxas_report(lib_path))

    # per kernel: max errors over its cases; ms, plain ms and bound at the
    # main path's shape
    kstat = {k: {"max_abs": 0.0, "max_rel": 0.0}
             for k in ("k1", "k2", "k3", "k6", "k7")}

    def record(key, case_is_main, aerr, rerr=None, **at_main):
        s = kstat[key]
        s["max_abs"] = max(s["max_abs"], aerr)
        s["max_rel"] = None if rerr is None else max(s["max_rel"], rerr)
        if case_is_main:
            s.update(at_main)

    # ---- 3. K1 against its plain version at the main path's shapes
    rng = np.random.default_rng(0)
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
        b_ms, b_by = bound(channel_ops(B, S, *pair_work(
                               V, A, True, grid.index(0.5), False)),
                           4 * (t.numel() + gps_t.numel() + ab.numel()
                                + z0.numel()), "f32")
        phase("k1_vs_plain", case=name, B=B, S=S, V=V, A=A, C=t.shape[0],
              max_rel_err=err, max_abs_err=aerr, tol=TOL, ms=ms,
              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        record("k1", name == "main", aerr, err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by)
        del t, gps_t, ab, z0, pab, pz0
    torch.cuda.empty_cache()

    # ---- 4. the fast engine's main path
    rng = np.random.default_rng(1)
    t0 = time.monotonic()
    csr = synth_pileup(rng, N_CELLS)
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, V))
    t_gen = time.monotonic() - t0
    fields, counts = drive_engine(csr, gps, "fast", dev, [pair_fast])
    launches = {"k1": counts[pair_fast]}
    phase("engine", mode="fast", k1_launches=launches["k1"], gen_s=t_gen,
          card=card, **fields)

    with tempfile.TemporaryDirectory() as tmp:
        # ---- 5. the CLI (fast) against the host oracle
        base = cli_case(tmp, V, 150, 80)
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
            C, U = tab.lut.shape[1], codes.shape[2]
            b_ms, b_by = bound(
                B * S * (C * U + (sum(tab.cmask) + 3) * (LOG_OPS + 3)),
                4 * codes.numel() + msk.numel() + 8 * (
                    tab.lut.numel() + t.numel() + gl.numel()), "f64")
            phase("k2_vs_plain", case=name, B=B, S=S, U=U,
                  R=tab.lut.shape[0], C=C, max_rel_err=err,
                  max_abs_err=aerr, tol=FRONT_TOL, ms=ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by)
            record("k2", name == "main", aerr, err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by)
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
            b_ms, b_by = bound(
                channel_ops(B, S, *pair_work(V, A, True, grid.index(0.5),
                                             True)),
                8 * (t.numel() + g.numel() + gl.numel()
                     + sum(x.numel() for x in got)), "f64")
            phase("k3_vs_plain", case=name, B=B, S=S, V=V, A=A,
                  C=t.shape[0], max_abs_err=aerr, max_rel_err=err,
                  tol=EXACT_TOL, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                  bound_by=b_by)
            record("k3", name == "main", aerr, err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by)
            del tab, codes, msk, g, t, gl, pt, pgl, got, want
        torch.cuda.empty_cache()

        # ---- 7. the exact engine's main path, on the same pileup
        fields, counts = drive_engine(csr, gps, "exact", dev, [k2, k3])
        launches.update(k2=counts[k2], k3=counts[k3])
        phase("engine", mode="exact", k2_launches=counts[k2],
              k3_launches=counts[k3], card=card, **fields)

        # ---- 8. the CLI's default mode (exact) against the host oracle
        cells, named = cli_vs_parity(base, tmp, [k2, k3], parity=parity)
        phase("cli", mode="exact (default)", cells=cells, samples=V,
              single_sing2_byte_identical=True, best_equal_parity=True,
              launches=named)

    # ---- 9. K7' and K6' against their plain versions
    rng = np.random.default_rng(4)
    for name, B, S, nv, grid in (
        ("v32_a5", 2048, 1024, 32, GRID),
        ("main", 2048, 1024, V_LARGE, GRID_LARGE),
        ("v20_a2", 2048, 1024, 20, [0.0, 0.5]),
        ("v17_a3", 2048, 1024, 17, [0.0, 0.25, 0.5]),
        # V*V*A = 392 on one ragged 8-tile
        ("ragged", 40, 384, 7, np.linspace(0.0, 0.5, 8).tolist()),
    ):
        A = len(grid)
        a0_sep, sym_a = grid[0] == 0.0, grid.index(0.5)
        tab, codes, msk, g = exact_inputs(rng, B, S, grid, dev, nv)
        t, gl = front_exact(codes, tab.lut, msk, tab.cmask, tab.gsel)
        del codes, msk
        plan = PT.plan_tiles(nv, A, a0_sep, sym_a)
        a7 = (t, g, nv, A, plan, tab.expand)
        a6 = (t, g, gl, nv, A, a0_sep, tab.expand)
        got7, got6 = PT.pair_tiled(*a7), PT.extras(*a6)
        torch.cuda.synchronize()
        e7 = abs_err(got7, PT.pair_tiled_plain(*a7))
        e6 = abs_err(got6, PT.extras_plain(*a6))
        if not (np.isfinite(e7) and e7 <= EXACT_TOL
                and np.isfinite(e6) and e6 <= EXACT_TOL):
            fail(f"K7'/K6' {name}: max absolute errors {e7}, {e6} > "
                 f"{EXACT_TOL}")
        plane = got7[..., sym_a]
        if not torch.equal(plane, plane.transpose(1, 2)):
            fail(f"K7' {name}: the alpha == 0.5 plane is not symmetric")
        big = B * S * nv * nv * A > 1 << 30  # the plain versions take ~1 s
        ms7 = median_ms(lambda: PT.pair_tiled(*a7))
        plain7 = median_ms(lambda: PT.pair_tiled_plain(*a7), n=3 if big else 10)
        ms6 = median_ms(lambda: PT.extras(*a6))
        plain6 = median_ms(lambda: PT.extras_plain(*a6), n=3 if big else 10)
        chans = sum(nv * (nv + 1) // 2 if a == sym_a else nv * nv
                    for a in plan.alist)
        b7 = bound(channel_ops(B, S, chans, nv * len(plan.alist)),
                   8 * (t.numel() + g.numel() + got7.numel()), "f64")
        keys = PT.extras_keys(nv, A, a0_sep)
        b6 = bound(channel_ops(B, S, len(keys),
                               sum(k[0] == "m0" for k in keys)),
                   8 * (t.numel() + g.numel() + gl.numel() + got6.numel()),
                   "f64")
        phase("k7_k6_vs_plain", case=name, B=B, S=S, V=nv, A=A, C=t.shape[0],
              tile=plan.tile, tile_items=len(plan.items), k7_max_abs_err=e7,
              k6_max_abs_err=e6, tol=EXACT_TOL, k7_ms=ms7,
              k7_plain_ms=plain7, k7_bound_ms=b7[0], k7_bound_by=b7[1],
              k6_ms=ms6, k6_plain_ms=plain6, k6_bound_ms=b6[0],
              k6_bound_by=b6[1])
        record("k7", name == "main", e7, ms=ms7, plain_ms=plain7,
               bound_ms=b7[0], bound_by=b7[1])
        record("k6", name == "main", e6, ms=ms6, plain_ms=plain6,
               bound_ms=b6[0], bound_by=b6[1])
        del tab, g, t, gl, got7, got6, plane
    torch.cuda.empty_cache()

    # ---- 10. the exact engine on a large pool: the same pileup scored
    # against 32 donors on the default grid (K2', K7', K6'; never K3')
    gps_large = np.random.default_rng(5).dirichlet(np.ones(3),
                                                   size=(NSNPS, V_LARGE))
    fields, counts = drive_engine(csr, gps_large, "exact", dev, [k2, k7, k6],
                                  grid=GRID_LARGE, absent=[k3])
    launches.update(k7=counts[k7], k6=counts[k6])
    phase("engine", mode="exact", k2_launches=counts[k2],
          k7_launches=counts[k7], k6_launches=counts[k6],
          k3_launches=counts[k3], card=card, **fields)

    # ---- 11. the CLI's default mode on a large pool against the oracle
    with tempfile.TemporaryDirectory() as tmp:
        base = cli_case(tmp, 16, 100, 40)
        cells, named = cli_vs_parity(base, tmp, [k2, k7, k6], absent=[k3])
        phase("cli", mode="exact (default)", cells=cells, samples=16,
              alphas=2, single_sing2_byte_identical=True,
              best_equal_parity=True, launches=named)

    # ---- 12. where the device time goes, per run
    for mode, g, grid in (("exact", gps, GRID), ("fast", gps, GRID),
                          ("exact", gps_large, GRID_LARGE)):
        phase("trace", card=card, **profile_engine(csr, g, mode, dev, grid))

    def row(key, name, source, replaces):
        s = kstat[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": s["max_abs"], "max_rel_err": s["max_rel"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                # no single PyTorch call computes any of these functions
                "library_ms": None}

    src, jax = "demuxlet_tpu_torch/csrc/", "demuxlet_tpu/ops/"
    phase("total", seconds=time.monotonic() - START)
    print(json.dumps({"kernels": [
        row("k1", "pair_fast (K1)", src + "pair_fast.cu",
            jax + "pallas_pair.py:96"),
        row("k2", "front_exact (K2')", src + "front_exact.cu",
            jax + "pallas_pair_exact.py:962"),
        row("k3", "pair_exact (K3')", src + "pair_exact.cu",
            jax + "pallas_pair_exact.py:219"),
        row("k6", "extras_exact (K6')", src + "extras_exact.cu",
            jax + "pallas_pair_exact.py:698"),
        row("k7", "pair_tiled_exact (K7')", src + "pair_tiled_exact.cu",
            jax + "pallas_pair_exact.py:633"),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
