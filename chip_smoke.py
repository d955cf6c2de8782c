#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

Drives the port's device paths, fast-mode and exact-mode (the CLI default)
``DemuxEngine.run_compact``, the full-tensor ``DemuxEngine.run`` (with
its spool and its dense route), both on meshes, the multi-process merges
(over gloo and over NCCL) and the CLI, at the full width of the repo's
realistic configuration (V=8 donors, the 5-point alpha grid, 50,000 SNPs,
~1,000 covered SNPs per cell, --cell-block 2048), and both modes on a
large pool (V=32 donors on the CLI's default grid [0, 0.5], V*V*A = 2048:
the tiled K7' + K6' in exact mode, K5' + K4' in fast mode), after building
every kernel of those paths from the sources in this checkout and holding
each against its plain PyTorch version on the card. Phases, one line each:

  1. environment: torch/CUDA versions, the card's name and power limit;
  2. nvcc build of every csrc/*.cu, one nvcc each, all started together
     (seconds per kernel; ptxas's registers, stack and spills per
     instantiation; a spill or a stack frame in K1, K3', K4', K5', K6' or
     K7' fails);
  3. K1 against pair_llks_plain at the main-path shapes, a V=1 pool of
     384 alphas and the engine's deepest slot pad S = 4096 (max relative
     error, scale max(1, |x|), limit 2e-5; two launches bit-equal, the
     alpha == 0.5 plane exactly symmetric; median ms of 20 launches each);
  4. fast run_compact on a synthetic 20,480-cell pileup (10 blocks of
     2048), wire v2: K1 launch count == blocks, barcodes/s and phase
     seconds, and the first 2 and the last (deepest) block, with their
     slot pads S and lanes U, again with the plain pair search on the card;
  5. the CLI (--mode fast) on a BAM/VCF from tests/fixtures.py (150 cells,
     V=8): its .best calls equal the host-oracle --mode parity
     --write-pair calls;
  6. K2' (front_exact) and K3' (pair_exact) against their plain versions
     at the main-path shapes, the engine's deepest slot pad S = 4096 and,
     for K2', the engine's lane profile (U = 64 lanes as wire-v2 parts:
     U0 dense lanes and a sorted tail of K2p entries a cell; U, U0 and K2p
     printed) (K2': t and gl within 1e-12 relative; K3': LLKs within 1e-9
     absolute, two launches bit-equal, the alpha == 0.5 plane exactly
     symmetric, its dynamic shared memory; median ms of 20 launches each);
     and pair_exact on a V=1 pool of 200 alphas, whose t channels K3''s
     stages cannot hold: K7' and K6' launched, K3' not, within 1e-9;
  7. exact run_compact on the same pileup: K2' and K3' launched once per
     block and no deep lanes rebuilt (``ops/wire.rebuilds``: K2' reads the
     wire-v2 parts), barcodes/s and phase seconds, the first 2 and the last
     (deepest) block again through the plain versions on the card (floats
     within 1e-9 absolute, integer fields equal except counted near ties);
  8. the CLI with no --mode (exact) on the same BAM/VCF: .single and
     .sing2 byte-identical to --mode parity, .best equal after
     canonicalize_best; then with --write-pair (run() on K2' + K3', and no
     other kernel): .pair, .single and .sing2 byte-identical to parity's;
     and with --profile: its torch.profiler trace names K2' and K3'; then
     the input options on the same BAM/VCF with GP and PL added, one line
     a case: --field GP, --field PL, --sm (6 of 8 samples), --group-list
     (every other barcode) and --doublet-prior 0.3 on the 5-point grid,
     each with no --mode against --mode parity with the same options
     (.single and .sing2 byte-identical, .best equal after
     canonicalize_best, K2' and K3' launched; the parity runs are
     processes of their own, started together);
  9. K7' (pair_tiled_exact) and K6' (extras_exact) against their plain
     versions at B=2048, S=1024 for (V, A) = (32, 5), (32, 2), (64, 2),
     (20, 2), (17, 3), a ragged B=40/S=384 case (V=7, A=8: one 8-tile) and the
     deepest pad (V=32, A=2, S=4096): within 1e-9 absolute, K7' and K6'
     bit-equal over two launches, the plane exactly symmetric; kernel ms
     (median of CUDA-event timed launches), plain ms and K7''s and K6''s
     dynamic shared memory;
 10. exact run_compact on the same pileup with V=32 donors on the default
     grid: K2', K7' and K6' launched once per block, K3' never and no
     deep lanes rebuilt, rate,
     phase seconds, peak device memory, and the first 2 and the deepest
     block through the plain versions (1e-9 absolute, near ties counted);
 11. the CLI with no --mode on a V=16 default-grid BAM/VCF (100 cells,
     V*V*A = 512: K7' + K6') against --mode parity, as in phase 8, and
     --mode fast on it (K5' + K4', never K1): its .best calls equal that
     parity run's;
 12. K5' (pair_tiled_fast) and K4' (extras_fast) against their plain
     versions at the shapes of phase 9: within 2e-5 relative (scale
     max(1, |x|)), K5' and K4' bit-equal over two launches, the
     alpha == 0.5 plane exactly symmetric; kernel ms and plain ms, K4''s
     dynamic shared memory and its ptxas registers, stack and spills (a
     spill or a stack frame already failed phase 2);
 13. fast run_compact on the same pileup with V=32 donors on the default
     grid: K5' and K4' launched once per block and K1 never, rate, phase
     seconds, peak device memory, and the first 2 and the deepest block
     through the plain versions (2e-5 relative, near ties counted);
 14. per mode at V=8/A=5 and V=32/A=2, the full-tensor run() on the
     same pileup and then run_compact on the same engine: the route's
     kernels launched once per block and every other kernel never; llks and
     llk0s bit-equal to run_compact's; compact_from_result of run()'s
     tensors against run_compact's rows (1e-9 absolute exact, 2e-5
     relative fast; integer fields equal except counted near ties); the
     first 2 and the deepest block's four outputs through the plain
     versions; each call's rate, phase seconds, H2D and D2H bytes and peak
     device memory;
 15. exact run() at V=8 with a spool directory, twice: one file a block,
     the second run launches no kernel, its arrays bit-equal;
 16. the dense route (ops/likelihood.py) at V=8/A=5 on a cut pileup
     (1,024 cells of the same profile on blocks of 256): --exact-kernel xla
     and --cap-BQ 127 within 1e-9 of the kernel run() on it, f32 within
     2e-5 relative, no kernel of the port launched; rate and peak memory;
 17. per run (exact and fast at V=8, exact and fast at V=32), one more
     run_compact on the pileup (rate, phase seconds, peak device memory)
     and one under torch.profiler: the device's busy ms and idle share, the
     top ops by device ms, the port's kernels' ms per block slot pad, and
     (exact runs: none) the lane rebuilds;
 18. meshes (``parallel/mesh.py``): per mode at V=8/A=5 and V=32/A=2, an
     engine on a 2x1 mesh whose two members are this card: run_compact
     and run() bit-equal to one device's, the route's kernels launched
     once per block summed over the members and every other kernel never,
     rate, phase seconds and peak device memory beside one device's, the
     set-up seconds of the first call beside one device's and the host
     table builds per wire config (each must be 1: every member's tables
     are placed from one host build); exact run() on 1x2 and 2x2 meshes
     (the dense route split on the slot axis) on the cut pileup of phase
     16 within 1e-9 of the unsplit dense run,
     no kernel launched; with two or more cards the same over
     cuda:0/cuda:1, else a line that says it was not run;
 19. two processes over gloo on 127.0.0.1 (``parallel/multihost.py``),
     both on this card (``chip_smoke.py --multihost-worker RANK PORT
     PILEUP``, the pileup and genotypes in a file the script writes):
     the pileup's barcode stripes through run_compact + gather_compact
     against the one-process run_compact, its two halves of SNP ids (genome
     shards) through run() + gather_results_sum_compact against
     gather_results_sum + compact_from_result and the one-process run
     (1e-9 absolute, near ties counted), K2' and K3' launched once per
     block in each process; then the CLI as two processes on the phase-5
     BAM/VCF, barcode stripes and genome shards, each with and without
     --write-pair, then as three processes (barcode stripes) and four
     (genome shards): process 0's files byte-identical to one process's
     (genome .best after canonicalize_best; four genome shards: calls and
     ids equal, other fields within 1.5 rendering quanta), the other
     processes' none, and each process's --profile trace names K2' and
     K3'; per process its wall seconds, its merge's seconds and its
     traced K2' and K3' launches. Both processes drive this card, so their
     merge keys are equal and every process, worker and CLI, must name
     the "host" route (gloo on host tensors); the workers also run
     genome_merges on it (below);
 20. the genome-shard reduce-scatter over NCCL (``multihost_nccl``): two
     processes (``chip_smoke.py --nccl-worker RANK PORT PILEUP``), each with a
     card of its own as NCCL sees it: its own card through
     CUDA_VISIBLE_DEVICES where there are two, else this one card with a
     distinct NCCL_HOSTID a process (NCCL's host hash) and
     NCCL_SOCKET_IFNAME=lo; each must take the "nccl" route.
     genome_merges: per pool, exact V=8/A=5 (K2' + K3') and exact
     V=32/A=2 (K2' + K7' + K6'), each process's genome half of the
     pileup through run() (its route's kernels once per block, every
     other kernel never) and gather_results_sum_compact, timed from a
     barrier, with the bytes reduced (3 chunks of 2 x 4,096 rows at V=8,
     7 of 2 x 1,510 at V=32); process 0's merged rows bit-equal to the
     one-process merge (merge_shards_sum of both halves, decided on the
     card over the same stripes) and within 1e-9 of compact_from_result;
     the card (name, UUID, environment) of each process; then the CLI as
     two genome-shard processes so placed, byte-identical to one process,
     each NOTICE naming the "nccl" route.

Then a JSON line of per-kernel numbers (with each kernel's bound: the
larger of its operations over the card's peak rate for their type and its
bytes over the memory rate, counted as ``bound`` and ``channel_ops``
say), the card's name and power limit, and, last, the ok line. Any failure
exits non-zero before the ok line. With no CUDA device it exits 1 at once. Nothing of JAX, of the JAX
package or of oracle/ is imported.

Usage: python3 chip_smoke.py (one card; phases 8, 19 and 20 start their
processes themselves)
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
# the large pool: the tiled K7' + K6' (exact) and K5' + K4' (fast)
V_LARGE, GRID_LARGE = 32, [0.0, 0.5]
# the benchmark's widest pool (kang64_a2, kang64_a2_fast): 10 tile items a
# cell; its kernel times go into the kernels line beside the main shape's
V_WIDEST = 64
# the tiled kernels' cases: (name, B, S, V, grid); "main" is the large pool
# the dense route's cut: 1,024 cells of the same profile on blocks of 256
# (its host count slots, (B, S, 2 * (cap_bq + 1)) int32, stay under 2.2 GB
# a block at --cap-BQ 127 and the deepest pad, S = 8192)
DENSE_CELLS, DENSE_BLOCK = 1024, 256
TILED_CASES = (
    ("v32_a5", 2048, 1024, 32, GRID),
    ("main", 2048, 1024, V_LARGE, GRID_LARGE),
    ("v64", 2048, 1024, V_WIDEST, GRID_LARGE),
    ("v20_a2", 2048, 1024, 20, [0.0, 0.5]),
    ("v17_a3", 2048, 1024, 17, [0.0, 0.25, 0.5]),
    # V*V*A = 392 on one ragged 8-tile
    ("ragged", 40, 384, 7, np.linspace(0.0, 0.5, 8).tolist()),
)

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


def ptxas_summary(lines):
    """[{entry, registers, stack, spill_stores}] from ptxas's report of a
    library (``kernels/build.ptxas_report``): one entry per kernel
    instantiation, the report's lines after its "Compiling entry" line."""
    import re

    out = []
    for ln in lines:
        if ln.startswith("Compiling entry"):
            out.append({"entry": ln.split("'")[1] if "'" in ln else ln})
        elif out and "spill stores" in ln and "stack" not in out[-1]:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[-1].update(stack=nums[0], spill_stores=nums[1])
        elif out and ln.startswith("Used ") and "registers" not in out[-1]:
            out[-1]["registers"] = int(re.search(r"Used (\d+)", ln)[1])
    return out


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


def pair_inputs(rng, B, S, grid, dev, nv=V):
    """Main-path fast pair-search inputs for nv samples: t from real LUT
    rows and 1-3 observations per slot, flat-Dirichlet genotype posteriors
    drawn on the device and their mean as the background rows gp0_t (the
    front's host gp0), ~20% padded (neutral) slots. Returns (t, gps_t,
    gp0_t, expand), f32."""
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
    g = flat_dirichlet(rng, (nv, 3, B, S), dev)
    gp0_t = neutral_on(pad, g.mean(dim=0, keepdim=True).float())
    gps_t = neutral_on(pad, g.float())
    del g
    t = norm_t(torch.from_numpy(np.ascontiguousarray(
        lograw.transpose(2, 0, 1))).to(dev), 0).contiguous()
    return t, gps_t, gp0_t, expand


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
    from demuxlet_tpu_torch.models.engine import exact_host_tables, place

    tab = place(exact_host_tables(np.full((1, nv, 3), 1 / 3), grid, 40, None),
                dev)
    codes = rng.choice(np.r_[23, 37, 41 + 23, 41 + 37], size=(B, S, 3))
    nobs = rng.integers(1, 4, size=(B, S))
    pad = rng.random((B, S)) < 0.2
    codes[(np.arange(3) >= nobs[..., None]) | pad[..., None]] = 255
    g = flat_dirichlet(rng, (nv, 3, B, S), dev)
    g = neutral_on(pad, torch.cat([g, g.mean(dim=0, keepdim=True)]))
    codes = torch.from_numpy(codes.astype(np.int32)).to(dev)
    return tab, codes, torch.from_numpy(~pad).to(dev), g


def lane_profile_inputs(rng, B, S, dev, grid=GRID, nv=V, U=64):
    """K2' inputs at the engine's lane profile, as the exact path reads
    them: a block of 1 + Poisson(0.15) UMIs per slot, ~1% PCR-hot slots of
    32-64 UMIs and ~20% padded slots on a 4-code wire-v2 dictionary (a
    5-row exact LUT), split into U0 dense lanes and a sorted tail by the
    packer's own rule (``host/wire._split_tail``, U0 from its cost model).
    Returns (tab, dense (B,S,U0), (tpos, tcode) (B,K2p) or None, U - U0,
    msk, g, info) on dev: msk derived from the dense lanes as the unpacker
    does, g as ``exact_inputs`` draws it; info: U, U0, K2p, the tail width
    and its real entries."""
    from demuxlet_tpu_torch.host import wire as W
    from demuxlet_tpu_torch.models.engine import exact_host_tables, place

    cfg = W.WireCfg((23, 37, 41 + 23, 41 + 37), 4, 8)
    n = 1 + rng.poisson(0.15, size=(B, S))
    hot = rng.random((B, S)) < 0.01
    n[hot] = rng.integers(32, U + 1, size=int(hot.sum()))
    n[rng.random((B, S)) < 0.2] = 0
    wc = np.full((B, S, U), cfg.none, np.uint8)
    occ = np.arange(U) < n[..., None]
    wc[occ] = rng.integers(0, cfg.n_real, size=int(occ.sum()))
    del occ
    dense, U0, K2p, tw, tpos, tcode = W._split_tail(wc, cfg)
    del wc
    D = U - U0
    tail, real = None, 0
    if K2p:
        if tw == 24:
            tpos = tpos[0].astype(np.int64) * D + tpos[1]
        tpos = tpos.astype(np.int32)
        real = int((tpos < S * D).sum())
        tail = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            torch.int32).to(dev) for x in (tpos, tcode))
    dense = torch.from_numpy(dense.astype(np.int32)).to(dev)
    msk = (dense != cfg.none).any(dim=-1)
    tab = place(exact_host_tables(np.full((1, nv, 3), 1 / 3), grid, 40, cfg),
                dev)
    g = flat_dirichlet(rng, (nv, 3, B, S), dev)
    g = neutral_on((~msk).cpu().numpy(),
                   torch.cat([g, g.mean(dim=0, keepdim=True)]))
    return tab, dense, tail, D, msk, g, dict(U=U, U0=U0, K2p=K2p, tw=tw,
                                             tail_entries=real)


def k2_bound(B, S, tab, dense, tail, real, msk, t, gl):
    """K2''s bound from the parts it reads: per slot its U0 dense codes,
    its C-wide LUT row adds for the dense lanes and the real tail entries,
    and the exps of the mixture and singlet channels; bytes: dense, tail,
    mask, LUT and the outputs."""
    C = tab.lut.shape[1]
    ops = (dense.numel() + real) * C \
        + B * S * (sum(tab.cmask) + 3) * (LOG_OPS + 3)
    nbytes = 4 * dense.numel() + msk.numel() + 8 * (
        tab.lut.numel() + t.numel() + gl.numel())
    if tail is not None:
        nbytes += 8 * tail[0].numel()
    return bound(ops, nbytes, "f64")


def cli_case(tmp, n_samples, n_cells, reads_per_cell, fields=("GT",)):
    """A BAM/VCF from tests/fixtures.py (200 SNPs) in tmp, the VCF with the
    FORMAT fields ``fields``: GP and PL are written from the planted
    genotypes, as tests/test_golden_reference.py writes them."""
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
    for v in variants:
        for smp in v.samples:
            g = {"0/0": 0, "0/1": 1, "1/1": 2}[smp["GT"]]
            if "GP" in fields:
                smp["GP"] = ",".join("0.96" if i == g else "0.02"
                                     for i in range(3))
            if "PL" in fields:
                smp["PL"] = ",".join("0" if i == g else "60"
                                     for i in range(3))
    vcf = write_vcf(os.path.join(tmp, "w.vcf"), names, variants,
                    contigs=contigs, fmt_keys=list(fields))
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


def fast_cli_vs_parity(base, tmp, parity, kernels, absent=()):
    """The CLI with --mode fast against --mode parity's files on one input:
    equal BEST columns after canonicalize_best_line, every kernel of
    ``kernels`` launched and none of ``absent``. Returns (cells, {kernel:
    launches})."""
    from parity_utils import canonicalize_best_line

    for k in (*kernels, *absent):
        k.reset_launches()
    fast = run_cli(base, tmp, "fast", "fast")
    counts = {k.__name__.rsplit(".", 1)[1]: k.launches
              for k in (*kernels, *absent)}
    calls = [[canonicalize_best_line(l).split("\t")[5] for l in f[1:]]
             for f in (fast[".best"], parity[".best"])]
    if (not calls[0] or calls[0] != calls[1]
            or min(k.launches for k in kernels) < 1
            or any(k.launches for k in absent)):
        fail(f"CLI fast vs parity: {len(calls[0])} rows, "
             f"{sum(a != b for a, b in zip(*calls))} calls differ, launches "
             f"{counts}")
    return len(calls[0]), counts


def run_cli(base, tmp, name, mode=None, extra=()):
    """One CLI run into tmp/name (no --mode: the parser default), with
    extra arguments; returns its output files' lines (.pair where
    written)."""
    from demuxlet_tpu_torch import cli

    out = os.path.join(tmp, name)
    argv = base + ["--out", out] + ([] if mode is None else ["--mode", mode])
    if cli.main(argv + list(extra)) != 0:
        fail(f"CLI {name} returned non-zero")
    return read_outputs(out)


def read_outputs(out):
    """The lines of a CLI run's output files (.pair where written)."""
    files = {}
    for ext in (".single", ".sing2", ".best", ".pair"):
        if ext != ".pair" or os.path.exists(out + ext):
            with open(out + ext) as fh:
                files[ext] = fh.read().splitlines()
    return files


def exact_pair_plain_of(V, A):
    """The plain version of the exact pair search the engine's route takes
    at V samples and A alphas (K3''s, or K7' + K6''s)."""
    import functools

    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.pair import unrolled
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact_plain

    if unrolled(V, A):
        return pair_exact_plain
    return functools.partial(PT.pair_exact_tiled, pair_fn=PT.pair_tiled_plain,
                             extras_fn=PT.extras_plain)


def pack_rows(comp, llks, llk0s):
    """A CompactResult and its singlet LLKs as the packed decision rows."""
    from demuxlet_tpu_torch.models import decision as D

    return np.concatenate(
        [comp.sing_col, comp.llk_00]
        + [getattr(comp, k).astype(np.float64)[:, None] for k in D._PACK_KEYS]
        + [llks, llk0s[:, None]], axis=1)


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
    from demuxlet_tpu_torch.ops.wire import decode

    cfg = eng._packer.choose(csr)
    tab = eng._tables(eng.mode)
    V, A = eng.nv, len(eng.grid_alpha)
    exact_pair_plain = exact_pair_plain_of(V, A)
    dbl_w = torch.as_tensor(D.doublet_weights(V, eng.grid_alpha, 0.5),
                            dtype=torch.float64, device=dev)
    dbl_msk = torch.as_tensor(D.doublet_mask(V, A), device=dev)
    kw = dict(a0_sep=True, sym_a=eng.grid_alpha.index(0.5))
    got, ref, checked = [], [], []
    for i in sorted({0, 1, len(blocks) - 1} & set(range(len(blocks)))):
        cells = blocks[i]
        blk = eng._packer.pack(csr, cells, cfg, pads[i] if pads else None)
        # the v2 wire's meta: the form, S, then U, the full-lane count
        checked.append(dict(block=i, S=blk.meta[1], U=blk.meta[2],
                            cells=len(cells)))
        parts = decode(_h2d(blk.bufs, dev), blk.meta)
        if exact:
            rows = D.compact_step_body_exact(
                parts, tab, A, V, dbl_w, dbl_msk, 0.5,
                front_fn=front_exact_plain, pair_fn=exact_pair_plain, **kw)
        else:
            rows = D.compact_step_body(
                parts, tab, A, V, dbl_w, dbl_msk, 0.5,
                pair_fn=pair_llks_plain, **kw)
        ref.append(rows.cpu().numpy()[: len(cells)])
        got.append(pack_rows(D.take(comp, np.asarray(cells)), llks[cells],
                             llk0s[cells]))
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
    from demuxlet_tpu_torch.ops import wire

    nv = gps.shape[1]
    # warm-up on another pileup: builds the native packer, inits cuBLAS
    DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode,
                device=dev).run_compact(
        synth_pileup(np.random.default_rng(2), CELL_BLOCK), 0.5)
    torch.cuda.synchronize()
    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
    for k in (*kernels, *absent):
        k.reset_launches()
    wire.rebuilds = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: k.launches for k in (*kernels, *absent)}
    rebuilds = wire.rebuilds
    if mode == "exact" and rebuilds:
        fail(f"exact engine rebuilt deep lanes {rebuilds} times: K2' reads "
             "the wire-v2 parts")
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
    if eng._cfg is None:
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
                  near_tie_cells=ties, lane_rebuilds=rebuilds)
    fields["plain_max_abs_err" if exact else "plain_max_rel_err"] = err
    return fields, launches


def run_vs_plain(eng, csr, res, blocks, pads, dev):
    """The first 2 blocks of a run() and its last (the deepest) again,
    through the plain versions of the route's kernels on the same device:
    the max error of the four outputs (absolute in exact mode, relative in
    fast mode) and [{block, S, U, cells}]."""
    from demuxlet_tpu_torch.models.engine import _h2d
    from demuxlet_tpu_torch.ops.front import fast_front
    from demuxlet_tpu_torch.ops.front_exact import (
        exact_block,
        front_exact_plain,
    )
    from demuxlet_tpu_torch.ops.pair import pair_llks_plain
    from demuxlet_tpu_torch.ops.wire import decode

    cfg = eng._packer.choose(csr)
    tab = eng._tables(eng.mode)
    V, A = eng.nv, eng.n_alpha
    exact = eng.mode == "exact"
    err_fn = abs_err if exact else rel_err
    err, checked = 0.0, []
    for i in sorted({0, 1, len(blocks) - 1} & set(range(len(blocks)))):
        cells = blocks[i]
        blk = eng._packer.pack(csr, cells, cfg, pads[i] if pads else None)
        checked.append(dict(block=i, S=blk.meta[1], U=blk.meta[2],
                            cells=len(cells)))
        parts = decode(_h2d(blk.bufs, dev), blk.meta)
        kw = dict(a0_sep=True, sym_a=eng.grid_alpha.index(0.5))
        if exact:
            outs = exact_block(parts, tab, A, V, front_fn=front_exact_plain,
                               pair_fn=exact_pair_plain_of(V, A), **kw)
        else:
            outs = fast_front(parts, tab, A, V, pair_fn=pair_llks_plain,
                              **kw)
        for got, want in zip((res.llks, res.llk0s, res.llk_ab, res.llk_00),
                             outs):
            err = max(err, err_fn(torch.from_numpy(got[cells]),
                                  want[: len(cells)].cpu()))
    return err, checked


def engine_stats(eng, n, wall, peak):
    return dict(seconds=wall, barcodes_per_s=n / wall,
                phase_s=dict(eng.phase_s), h2d_bytes=eng.h2d_bytes,
                d2h_bytes=eng.d2h_bytes, peak_device_gb=peak / 1e9)


def drive_run(csr, gps, mode, dev, kernels, every, grid=GRID):
    """The full-tensor run() of the given mode and grid on csr, then
    run_compact on the same engine (its tables built by a run_compact
    before either): every launch count of ``every`` set to 0 just before
    run() and read just after; the path's ``kernels`` launched once per
    block, the others never; llks and llk0s bit-equal to run_compact's;
    compact_from_result of run()'s tensors against run_compact's rows
    (floats within the mode's tolerance, integer fields equal except
    counted near ties); the first 2 and the deepest block through the plain
    versions. Returns (phase fields, {kernel: launches}, engine, result)."""
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
    eng.run_compact(csr, 0.5)  # the engine's tables
    torch.cuda.synchronize()
    for k in every:
        k.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    res = eng.run(csr)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: k.launches for k in every}
    run_stats = engine_stats(eng, csr.nbcs, wall, peak)
    blocks, pads = eng._blocks(csr.nbcs, csr)
    named = {k.__name__.rsplit(".", 1)[1]: n for k, n in launches.items()}
    if any(launches[k] != len(blocks) for k in kernels) or any(
            launches[k] for k in every if k not in kernels):
        fail(f"{mode} run(): launches {named} for {len(blocks)} blocks")
    nv, A = gps.shape[1], len(grid)
    if not (res.llk_ab.shape == (csr.nbcs, nv, nv, A)
            and all(np.isfinite(x).all() for x in (
                res.llks, res.llk0s, res.llk_ab, res.llk_00))):
        fail(f"{mode} run() outputs are not finite or have the wrong shape")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    compact_stats = engine_stats(eng, csr.nbcs, time.monotonic() - t0,
                                 torch.cuda.max_memory_allocated())
    if not (np.array_equal(res.llks, llks)
            and np.array_equal(res.llk0s, llk0s)):
        fail(f"{mode} run(): llks or llk0s differ from run_compact's")
    exact = mode == "exact"
    tol = EXACT_TOL if exact else TOL
    t0 = time.monotonic()
    decided = D.compact_from_result(res.llk_ab, res.llk_00, grid, 0.5)
    host_decision_s = time.monotonic() - t0
    err_c, ties = compare_rows(pack_rows(decided, res.llks, res.llk0s),
                               pack_rows(comp, llks, llk0s), nv, A, tol,
                               absolute=exact)
    err_p, checked = run_vs_plain(eng, csr, res, blocks, pads, dev)
    if not (err_c <= tol and err_p <= tol):
        fail(f"{mode} run(): compact_from_result vs run_compact {err_c}, "
             f"vs plain {err_p} > {tol}")
    fields = dict(cells=csr.nbcs, samples=nv, alphas=A, blocks=len(blocks),
                  route=eng.route, run=run_stats, run_compact=compact_stats,
                  llks_bit_equal_run_compact=True,
                  host_compact_from_result_s=host_decision_s,
                  compact_max_err=err_c, near_tie_cells=ties,
                  plain_check_blocks=checked, plain_max_err=err_p, tol=tol,
                  launches=named)
    return fields, named, eng, res


def spool_twice(eng, csr, every, dev):
    """run() with a spool directory twice on one engine: one file a block;
    the second run launches no kernel (launch counts set to 0 just before
    it) and its arrays are bit-equal to the first's."""
    with tempfile.TemporaryDirectory() as sd:
        t0 = time.monotonic()
        first = eng.run(csr, spool_dir=sd)
        t_first = time.monotonic() - t0
        files = os.listdir(sd)
        nbytes = sum(os.path.getsize(os.path.join(sd, f)) for f in files)
        for k in every:
            k.reset_launches()
        t0 = time.monotonic()
        again = eng.run(csr, spool_dir=sd)
        t_again = time.monotonic() - t0
        launched = {k.__name__.rsplit(".", 1)[1]: k.launches for k in every}
    n_blocks = len(eng._blocks(csr.nbcs, csr)[0])
    same = all(np.array_equal(a, b) for a, b in zip(
        (first.llks, first.llk0s, first.llk_ab, first.llk_00),
        (again.llks, again.llk0s, again.llk_ab, again.llk_00)))
    if len(files) != n_blocks or any(launched.values()) or not same:
        fail(f"spool: {len(files)} files for {n_blocks} blocks, second run "
             f"launches {launched}, arrays bit-equal {same}")
    return dict(mode=eng.mode, blocks=n_blocks, files=len(files),
                spool_bytes=nbytes, first_s=t_first, second_s=t_again,
                second_launches=launched, bit_equal=True,
                second_h2d_bytes=eng.h2d_bytes)


def drive_dense(gps, dev, every):
    """The dense route (build_slots count slots through ops/likelihood.py)
    on a cut pileup: --exact-kernel xla in f64 and --cap-BQ 127 (the
    pileup's qualities lie below 40, so both equal the kernel route) within
    EXACT_TOL of the kernel run() on the same pileup and blocks, f32 within
    TOL relative; no kernel of the port launched. Returns phase lines."""
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    cut = synth_pileup(np.random.default_rng(8), DENSE_CELLS)
    kern = DemuxEngine(gps, GRID, cell_block=DENSE_BLOCK,
                       device=dev).run(cut)
    want = (kern.llks, kern.llk0s, kern.llk_ab, kern.llk_00)
    out = []
    for name, kw, tol in (("xla", dict(exact_kernel="xla"), EXACT_TOL),
                          ("f32", dict(dtype=torch.float32), TOL),
                          ("cap127", dict(cap_bq=127), EXACT_TOL)):
        eng = DemuxEngine(gps, GRID, cell_block=DENSE_BLOCK, device=dev, **kw)
        for k in every:
            k.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = eng.run(cut)
        stats = engine_stats(eng, cut.nbcs, time.monotonic() - t0,
                             torch.cuda.max_memory_allocated())
        launched = {k.__name__.rsplit(".", 1)[1]: k.launches for k in every}
        err_fn = rel_err if name == "f32" else abs_err
        err = max(err_fn(torch.from_numpy(g), torch.from_numpy(w)) for g, w
                  in zip((res.llks, res.llk0s, res.llk_ab, res.llk_00), want))
        if not err <= tol or any(launched.values()) or not \
                eng.route.startswith("dense"):
            fail(f"dense {name}: max error {err} > {tol} against the kernel "
                 f"run(), launches {launched}, route {eng.route}")
        out.append(dict(option=name, cells=cut.nbcs, cell_block=DENSE_BLOCK,
                        samples=gps.shape[1], alphas=len(GRID),
                        route=eng.route, max_err_vs_kernel_run=err, tol=tol,
                        relative=name == "f32",
                        slot_pads=sorted({_bucket_of(eng, cut, b) for b in
                                          eng._blocks(cut.nbcs, cut)[0]}),
                        **stats))
    return out


def _bucket_of(eng, csr, cells):
    """The dense route's slot pad of a block: its max covered SNPs, padded
    to 8 and bucketed to a power of two (``host/slots``, ``_bucket``)."""
    from demuxlet_tpu_torch.models.engine import _bucket

    m = int(np.asarray(csr.n_snps_all())[cells].max())
    return _bucket(-(-m // 8) * 8)


def profile_trace_kernels(path):
    """{kernel: launches} of the port's own kernels in a Chrome trace."""
    with open(path) as fh:
        ev = json.load(fh)["traceEvents"]
    out = {}
    for e in ev:
        if e.get("cat") == "kernel":
            for k, v in OWN_KERNELS.items():
                if k in e["name"]:
                    out[v] = out.get(v, 0) + 1
    return out


# the port's own kernels, by the name CUPTI records for them
OWN_KERNELS = {"front_exact_kernel": "K2'", "pair_exact_kernel": "K3'",
               "pair_fast_kernel": "K1", "pair_tiled_exact_kernel": "K7'",
               "extras_exact_kernel": "K6'", "pair_tiled_fast_kernel": "K5'",
               "extras_fast_kernel": "K4'"}


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
    untraced run_compact (wall, rate, phase seconds, the kernels' slots
    per covered slot and the fast front's scatter entries from the
    engine's counts, peak device memory)
    and one under torch.profiler, whose exported trace gives the device's
    busy time, its idle share of the untraced wall, the top ops and the
    port's kernels' ms per block slot pad."""
    from torch.profiler import ProfilerActivity, profile

    from demuxlet_tpu_torch.models.engine import DemuxEngine
    from demuxlet_tpu_torch.ops import wire

    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
    eng.run_compact(csr, 0.5)  # the engine's tables
    wire.rebuilds = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated()
    phase_s = dict(eng.phase_s)
    # the slots the kernels ran over, padding included, per covered slot
    padded = eng.counts["slots_kernel"] / max(int(csr.n_snps_all().sum()), 1)
    front_entries = eng.counts["front_entries"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.run_compact(csr, 0.5)
        torch.cuda.synchronize()
    rebuilds = wire.rebuilds
    if mode == "exact" and rebuilds:
        fail(f"traced exact runs rebuilt deep lanes {rebuilds} times")
    blocks, pads = eng._blocks(csr.nbcs, csr)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        busy, top, by_s = trace_summary(path, pads or [None] * len(blocks))
    return dict(mode=mode, samples=gps.shape[1], alphas=len(grid),
                cells=csr.nbcs, wall_s=wall,
                barcodes_per_s=csr.nbcs / wall, phase_s=phase_s,
                slots_kernel_per_real=padded, front_entries=front_entries,
                peak_device_gb=peak / 1e9,
                device_busy_ms=busy,
                idle_share=1.0 - busy / 1e3 / wall, top_device_ms=top,
                kernel_ms_by_S=by_s, lane_rebuilds=rebuilds)


def sub_pileup(csr, cells=None, snps=None):
    """csr restricted to the cells ``cells`` (renumbered in that order: a
    barcode stripe) or to the observations of SNP ids in [lo, hi) = snps
    (every cell kept, its counters counting those observations, as
    synth_pileup's count them: a genome shard)."""
    from demuxlet_tpu_torch.host.csr import CsrPileup

    obs_cell = np.repeat(np.arange(csr.nbcs), np.diff(csr.cell_ptr))
    keep = np.ones(len(obs_cell), bool)
    barcodes, totl = list(csr.barcodes), csr.cell_totl
    if cells is not None:
        new_id = np.full(csr.nbcs, -1, np.int64)
        new_id[cells] = np.arange(len(cells))
        obs_cell = new_id[obs_cell]
        keep = obs_cell >= 0
        barcodes = [csr.barcodes[c] for c in cells]
        totl = csr.cell_totl[cells]
    if snps is not None:
        keep &= (csr.obs_snp >= snps[0]) & (csr.obs_snp < snps[1])
        totl = np.bincount(obs_cell[keep], minlength=len(barcodes))
    return CsrPileup.from_arrays(
        csr.sample_ids, csr.nsnps, barcodes, totl, totl, totl,
        obs_cell[keep], csr.obs_snp[keep].astype(np.int64),
        csr.obs_allele[keep], csr.obs_bq[keep])


def on_devices(n_b, n_s, devs):
    """An n_b x n_s mesh whose members take the devices devs in turn."""
    from demuxlet_tpu_torch.parallel import mesh as pmesh

    n = n_b * n_s
    return pmesh.make_mesh(n_b, n_s, devices=[devs[i % len(devs)]
                                              for i in range(n)])


def drive_mesh(csr, gps, mode, dev, kernels, every, grid, mesh):
    """run_compact, then run(), of one mode and pool on a mesh, against
    the same calls of an engine on one device (both first calls, tables
    built inside): every launch count set to 0 just before each mesh call
    and read just after, the route's kernels launched once per block
    summed over the members and the others never; every output bit-equal
    to the one device's. Returns the phase fields."""
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    def timed(eng, call):
        for k in every:
            k.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        out = eng.run_compact(csr, 0.5) if call == "run_compact" else \
            eng.run(csr)
        stats = engine_stats(eng, csr.nbcs, time.monotonic() - t0,
                             torch.cuda.max_memory_allocated())
        return out, stats, {k: k.launches for k in every}

    def fields(call, out):
        if call == "run_compact":
            llks, llk0s, comp = out
            return [llks, llk0s] + [getattr(comp, f) for f in
                                    D.CompactResult.__dataclass_fields__]
        return [out.llks, out.llk0s, out.llk_ab, out.llk_00]

    one = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, device=dev)
    want = {c: timed(one, c)[:2] for c in ("run_compact", "run")}
    n_blocks = len(one._blocks(csr.nbcs, csr)[0])
    del one
    torch.cuda.empty_cache()
    eng = DemuxEngine(gps, grid, cell_block=CELL_BLOCK, mode=mode, mesh=mesh)
    shape = "%dx%d" % (mesh.shape["b"], mesh.shape["s"])
    out = dict(mode=mode, samples=gps.shape[1], alphas=len(grid),
               cells=csr.nbcs, blocks=n_blocks, mesh=shape,
               members=[str(d) for row in mesh.devices for d in row])
    for call in ("run_compact", "run"):
        got, stats, launches = timed(eng, call)
        named = {k.__name__.rsplit(".", 1)[1]: n for k, n in launches.items()}
        if any(launches[k] != n_blocks for k in kernels) or any(
                n for k, n in launches.items() if k not in kernels):
            fail(f"mesh {shape} {mode} {call}: launches {named} for "
                 f"{n_blocks} blocks")
        if not all(np.array_equal(a, b) for a, b in zip(
                fields(call, got), fields(call, want[call][0]))):
            fail(f"mesh {shape} {mode} {call}: outputs differ from one "
                 "device's")
        out[call] = dict(mesh=stats, one_device=want[call][1],
                         launches=named, bit_equal_one_device=True)
    # the first call builds the tables: once on the host for every member
    builds = {f"{kind} {'v1' if cfg is None else 'v2'}": n
              for (kind, cfg), n in eng.host_table_builds.items()}
    if not builds or any(n != 1 for n in builds.values()):
        fail(f"mesh {shape} {mode}: host table builds {builds}")
    out.update(route=eng.route, host_table_builds=builds, setup_s=dict(
        mesh=out["run_compact"]["mesh"]["phase_s"]["setup"],
        one_device=out["run_compact"]["one_device"]["phase_s"]["setup"]))
    return out


def drive_mesh_dense(gps, dev, every, devs):
    """Exact run() on (1, 2) and (2, 2) meshes over devs (the dense route
    split on the slot axis) on the cut pileup, within EXACT_TOL of the
    unsplit dense route (--exact-kernel xla) on one device; no kernel of
    the port launched. Returns phase lines."""
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    cut = synth_pileup(np.random.default_rng(8), DENSE_CELLS)
    ref = DemuxEngine(gps, GRID, cell_block=DENSE_BLOCK, device=dev,
                      exact_kernel="xla").run(cut)
    out = []
    for n_b, n_s in ((1, 2), (2, 2)):
        mesh = on_devices(n_b, n_s, devs)
        eng = DemuxEngine(gps, GRID, cell_block=DENSE_BLOCK, mesh=mesh)
        for k in every:
            k.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        res = eng.run(cut)
        stats = engine_stats(eng, cut.nbcs, time.monotonic() - t0,
                             torch.cuda.max_memory_allocated())
        launched = {k.__name__.rsplit(".", 1)[1]: k.launches for k in every}
        err = max(abs_err(torch.from_numpy(g), torch.from_numpy(w)) for g, w
                  in zip((res.llks, res.llk0s, res.llk_ab, res.llk_00),
                         (ref.llks, ref.llk0s, ref.llk_ab, ref.llk_00)))
        if not err <= EXACT_TOL or any(launched.values()) or \
                "slot axis" not in eng.route:
            fail(f"mesh {n_b}x{n_s} dense: max error {err} > {EXACT_TOL} "
                 f"against the unsplit dense run(), launches {launched}, "
                 f"route {eng.route}")
        out.append(dict(mesh=f"{n_b}x{n_s}", cells=cut.nbcs,
                        members=[str(d) for row in mesh.devices for d in row],
                        route=eng.route, max_abs_err_vs_unsplit=err,
                        tol=EXACT_TOL, **stats))
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(argvs, timeout=600, env=None, envs=None):
    """Start one process per argument list (from the checkout's root, each
    writing to its own files, so no pipe fills while a peer waits in a
    collective), in the environment env, or envs[k] for process k, wait
    for all, kill any left at the time limit; returns
    [(rc, stdout, stderr, seconds)], seconds from the start to each
    process's exit."""
    with tempfile.TemporaryDirectory() as tmp:
        files = [(open(os.path.join(tmp, f"{i}.out"), "w+"),
                  open(os.path.join(tmp, f"{i}.err"), "w+"))
                 for i in range(len(argvs))]
        t0 = time.monotonic()
        envs = envs or [env] * len(argvs)
        procs = [subprocess.Popen(a, cwd=HERE, stdout=o, stderr=e,
                                  text=True, env=ev)
                 for a, (o, e), ev in zip(argvs, files, envs)]
        secs = [None] * len(procs)
        try:
            while None in secs and time.monotonic() - t0 < timeout:
                for i, p in enumerate(procs):
                    if secs[i] is None and p.poll() is not None:
                        secs[i] = time.monotonic() - t0
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        out = []
        for p, sec, (o, e) in zip(procs, secs, files):
            o.seek(0)
            e.seek(0)
            out.append((p.returncode, o.read(), e.read(), sec))
            o.close()
            e.close()
        return out


def save_pileup(path, csr, gps):
    """The pileup csr (a CsrPileup) and its genotypes gps in the .npz
    path, for the process pairs of phases 19 and 20 (``load_pileup``):
    making the pileup again takes each process about 8 s."""
    import dataclasses

    np.savez(path, gps=gps, **{f.name: np.asarray(getattr(csr, f.name))
                               for f in dataclasses.fields(csr)})


def load_pileup(path):
    """(csr, gps) as ``save_pileup`` wrote them."""
    from demuxlet_tpu_torch.host.csr import CsrPileup

    with np.load(path) as z:
        f = {k: z[k] for k in z.files}
    return CsrPileup(
        sample_ids=[str(x) for x in f.pop("sample_ids")],
        nsnps=int(f.pop("nsnps")),
        barcodes=[str(x) for x in f.pop("barcodes")],
        **{k: v for k, v in f.items() if k != "gps"}), f["gps"]


def multihost_worker(rank: int, port: int, pileup: str) -> int:
    """One of the multihost phase's two processes (``chip_smoke.py
    --multihost-worker RANK PORT PILEUP``), over gloo on 127.0.0.1:PORT:
    the pileup of phase 4 and its genotypes from the .npz PILEUP
    (``save_pileup``); (a) this process's barcode
    stripe through exact run_compact and gather_compact, (b) its half of
    the SNP ids (a genome shard) through exact run() and both
    gather_results_sum_compact (decided on the card) and
    gather_results_sum. Process 0 holds (a) against the one-process
    run_compact (floats within EXACT_TOL, integer fields equal except
    counted near ties; bit-equality reported), and (b) against
    compact_from_result of gather_results_sum and against the
    one-process run. Each prints one JSON line: its launch counts and
    times, and on process 0 the comparisons."""
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import DemuxEngine, cell_stats
    from demuxlet_tpu_torch.parallel import multihost as mh
    from demuxlet_tpu_torch.utils.device import resolve_device

    dev = resolve_device("auto")
    mh.initialize(f"127.0.0.1:{port}", 2, rank, device=dev)
    csr, gps = load_pileup(pileup)
    eng = DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, device=dev)
    out = dict(rank=rank, route=mh.current_route(), **card_of(dev))

    def counted(fn):
        for k in (k2, k3):
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = fn()
        torch.cuda.synchronize()
        return res, time.monotonic() - t0, dict(k2=k2.launches,
                                                k3=k3.launches)

    mine = [i for i, b in enumerate(csr.barcodes)
            if mh.owns_barcode(b, rank, 2)]
    stripe = sub_pileup(csr, cells=mine)
    (llks, llk0s, comp), secs, launches = counted(
        lambda: eng.run_compact(stripe, 0.5))
    out["stripe"] = dict(cells=stripe.nbcs, seconds=secs, launches=launches,
                         blocks=len(eng._blocks(stripe.nbcs, stripe)[0]))
    st = cell_stats(stripe)
    t0 = time.monotonic()
    merged = mh.gather_compact(mh.CompactShard(
        barcodes=st.barcodes, totl=st.totl, pass_=st.pass_, uniq=st.uniq,
        nsnp=st.nsnp, llks=llks, llk0s=llk0s, compact=comp))
    out["stripe"]["gather_s"] = time.monotonic() - t0

    half = sub_pileup(csr, snps=(rank * NSNPS // 2, (rank + 1) * NSNPS // 2))
    res, secs, launches = counted(lambda: eng.run(half))
    out["genome"] = dict(cells=half.nbcs, seconds=secs, launches=launches,
                         blocks=len(eng._blocks(half.nbcs, half)[0]))
    st = cell_stats(half)
    local = mh.ShardResult(
        barcodes=st.barcodes, totl=st.totl, pass_=st.pass_, uniq=st.uniq,
        nsnp=st.nsnp, llks=res.llks, llk0s=res.llk0s, llk_ab=res.llk_ab,
        llk_00=res.llk_00)
    t0 = time.monotonic()
    summed = mh.gather_results_sum_compact(local, GRID, 0.5, device=dev)
    out["genome"]["gather_sum_compact_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    full = mh.gather_results_sum(local)
    out["genome"]["gather_sum_s"] = time.monotonic() - t0
    if rank == 0:
        one = eng.run_compact(csr, 0.5)
        want = pack_rows(one[2], one[0], one[1])
        if merged.barcodes != list(csr.barcodes) or \
                summed.barcodes != list(csr.barcodes):
            fail("multihost: merged barcodes differ from the pileup's")
        rows = pack_rows(merged.compact, merged.llks, merged.llk0s)
        err, ties = compare_rows(rows, want, V, len(GRID), EXACT_TOL,
                                 absolute=True)
        out["stripe"].update(max_abs_err_vs_one_process=err,
                             near_tie_cells=ties,
                             bit_equal_one_process=bool(
                                 np.array_equal(rows, want)))
        decided = D.compact_from_result(full.llk_ab, full.llk_00, GRID, 0.5)
        got = pack_rows(summed.compact, summed.llks, summed.llk0s)
        err_f, ties_f = compare_rows(
            got, pack_rows(decided, full.llks, full.llk0s), V, len(GRID),
            EXACT_TOL, absolute=True)
        err_o, ties_o = compare_rows(got, want, V, len(GRID), EXACT_TOL,
                                     absolute=True)
        st = cell_stats(csr)
        counters = all(np.array_equal(getattr(summed, f), getattr(st, f))
                       for f in ("totl", "pass_", "uniq", "nsnp"))
        out["genome"].update(
            max_abs_err_vs_gather_sum=err_f,
            near_tie_cells_vs_gather_sum=ties_f,
            max_abs_err_vs_one_process=err_o,
            near_tie_cells_vs_one_process=ties_o,
            counters_equal_one_process=counters)
        if not (max(err, err_f, err_o) <= EXACT_TOL and counters):
            fail(f"multihost: {json.dumps(out)}")
    elif merged is not None or summed is not None or full is not None:
        fail("multihost: a gather returned rows on process 1")
    del eng
    out["genome_merge"] = genome_merges(csr, gps, rank, dev)
    mh.shutdown()
    print(json.dumps(out), flush=True)
    return 0


def card_of(dev):
    """The card a process drives, as its merge key and NCCL see it."""
    return dict(device=str(dev),
                device_name=torch.cuda.get_device_name(dev),
                uuid=str(torch.cuda.get_device_properties(dev).uuid),
                **{k: os.environ[k] for k in (
                    "CUDA_VISIBLE_DEVICES", "NCCL_HOSTID",
                    "NCCL_SOCKET_IFNAME") if k in os.environ})


def decided_in_stripes(m, grid, rows, dev):
    """The one-process merge m (merge_shards_sum) decided on dev over the
    stripes of ``rows`` rows that a two-process
    gather_results_sum_compact decides (the last chunk padded with zero
    rows): the packed (N, 2V+A+11) rows."""
    from demuxlet_tpu_torch.models import decision as D

    n, nv, _, na = m.llk_ab.shape
    pad = lambda x: torch.from_numpy(np.concatenate(
        [x, np.zeros((-n % (2 * rows),) + x.shape[1:], x.dtype)])).to(dev)
    ab, a00, llks, llk0s = (pad(x) for x in
                            (m.llk_ab, m.llk_00, m.llks, m.llk0s))
    dbl_w = torch.as_tensor(D.doublet_weights(nv, grid, 0.5), device=dev)
    dbl_msk = torch.as_tensor(D.doublet_mask(nv, na), device=dev)
    packed = []
    for i in range(0, len(ab), rows):
        sl = slice(i, i + rows)
        out = D.decide(ab[sl], a00[sl], dbl_w, dbl_msk, 0.5)
        packed.append(D.pack_rows(out, llks[sl], llk0s[sl]).cpu().numpy())
    return np.concatenate(packed)[:n]


def genome_merge(eng, csr, rank, grid, dev, kernels):
    """This process's genome half of csr (SNP ids below or above
    NSNPS / 2) through eng.run() and gather_results_sum_compact on this
    process's reduce-scatter route (two processes): the route's kernels
    launched once per block and every other kernel never; the merge
    timed from a barrier, with the bytes this process reduces. Process 0
    then runs the other half too, sums both (merge_shards_sum) and
    decides them on the card over the same stripes: the merged rows must
    equal those bit for bit (P = 2: a sum of two terms commutes) and lie
    within EXACT_TOL of compact_from_result's. Returns the fields."""
    import torch.distributed as dist

    from demuxlet_tpu_torch.kernels import (
        extras_exact,
        extras_fast,
        front_exact,
        pair_exact,
        pair_fast,
        pair_tiled_exact,
        pair_tiled_fast,
    )
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import cell_stats
    from demuxlet_tpu_torch.parallel import multihost as mh

    every = (pair_fast, front_exact, pair_exact, pair_tiled_exact,
             extras_exact, pair_tiled_fast, extras_fast)
    halves = [sub_pileup(csr, snps=(k * NSNPS // 2, (k + 1) * NSNPS // 2))
              for k in range(2)]

    def local_of(half):
        for k in every:
            k.reset_launches()
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = eng.run(half)
        secs = time.monotonic() - t0
        st = cell_stats(half)
        return mh.ShardResult(
            barcodes=st.barcodes, totl=st.totl, pass_=st.pass_,
            uniq=st.uniq, nsnp=st.nsnp, llks=res.llks, llk0s=res.llk0s,
            llk_ab=res.llk_ab, llk_00=res.llk_00), secs, {
                k.__name__.rsplit(".", 1)[1]: k.launches for k in every}

    local, run_s, launched = local_of(halves[rank])
    n_blocks = len(eng._blocks(halves[rank].nbcs, halves[rank])[0])
    names = [k.__name__.rsplit(".", 1)[1] for k in kernels]
    if any(launched[k] != (n_blocks if k in names else 0) for k in launched):
        fail(f"genome merge: rank {rank} launches {launched} for "
             f"{n_blocks} blocks of {names}")
    nv, na = eng.nv, eng.n_alpha
    F = nv * nv * na + na + nv + 1
    rows = mh.stripe_rows(2, F)
    chunks = -(-csr.nbcs // (2 * rows))
    dist.barrier()
    t0 = time.monotonic()
    merged = mh.gather_results_sum_compact(local, grid, 0.5, device=dev)
    merge_s = time.monotonic() - t0
    out = dict(samples=nv, alphas=na, cells=csr.nbcs, blocks=n_blocks,
               launches=launched, run_s=run_s, route=mh.current_route(),
               merge_s=merge_s, bytes_reduced=chunks * 2 * rows * F * 8,
               chunks=chunks, stripe_rows=rows)
    if rank != 0:
        if merged is not None:
            fail("genome merge: process 1 returned rows")
        return out
    other = local_of(halves[1])[0]
    m = mh.merge_shards_sum([local, other])
    got = pack_rows(merged.compact, merged.llks, merged.llk0s)
    want = decided_in_stripes(m, grid, rows, dev)
    counters = all(np.array_equal(getattr(merged, f), getattr(m, f))
                   for f in ("totl", "pass_", "uniq", "nsnp"))
    bit = bool(merged.barcodes == m.barcodes and counters
               and np.array_equal(got, want))
    err, ties = compare_rows(
        got, pack_rows(D.compact_from_result(m.llk_ab, m.llk_00, grid, 0.5),
                       m.llks, m.llk0s), nv, na, EXACT_TOL, absolute=True)
    out.update(bit_equal_one_process=bit,
               max_abs_err_vs_compact_from_result=err,
               near_tie_cells_vs_compact_from_result=ties)
    if not (bit and err <= EXACT_TOL):
        fail(f"genome merge: {json.dumps(out)}")
    return out


def genome_merges(csr, gps, rank, dev):
    """genome_merge at V=8/A=5 (K2' + K3') and V=32/A=2 (K2' + K7' +
    K6'), exact mode, on the pileup csr."""
    from demuxlet_tpu_torch.kernels import extras_exact as k6
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.kernels import pair_tiled_exact as k7
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    out = []
    for g, grid, kernels in ((gps, GRID, (k2, k3)),
                             (gps_large_of(), GRID_LARGE, (k2, k7, k6))):
        eng = DemuxEngine(g, grid, cell_block=CELL_BLOCK, device=dev)
        out.append(genome_merge(eng, csr, rank, grid, dev, kernels))
        del eng
        torch.cuda.empty_cache()
    return out


def gps_large_of():
    """The V=32 pool's genotypes (phases 10-18)."""
    return np.random.default_rng(5).dirichlet(np.ones(3),
                                              size=(NSNPS, V_LARGE))


def nccl_worker(rank: int, port: int, pileup: str) -> int:
    """One of phase 20's two processes (``chip_smoke.py --nccl-worker RANK
    PORT PILEUP``), each driving a card of its own as NCCL sees it (its
    own card, or a distinct NCCL_HOSTID on the one card): joins on
    127.0.0.1:PORT, where the route must be "nccl"; the pileup of phase 4
    from PILEUP (``save_pileup``); genome_merges. Prints one JSON line."""
    from demuxlet_tpu_torch.parallel import multihost as mh
    from demuxlet_tpu_torch.utils.device import resolve_device

    dev = resolve_device("auto")
    mh.initialize(f"127.0.0.1:{port}", 2, rank, device=dev)
    out = dict(rank=rank, route=mh.current_route(), **card_of(dev))
    if out["route"] != "nccl":
        fail(f"nccl worker: route {json.dumps(out)}")
    csr, gps = load_pileup(pileup)
    out["genome_merge"] = genome_merges(csr, gps, rank, dev)
    mh.shutdown()
    print(json.dumps(out), flush=True)
    return 0


def own_card_envs(n=2):
    """Per process, the environment that gives it a card of its own as
    NCCL sees it: its own card where there are n, else, on one card, a
    distinct NCCL_HOSTID (NCCL's host hash) over sockets on loopback."""
    if torch.cuda.device_count() >= n:
        return [dict(os.environ, CUDA_VISIBLE_DEVICES=str(k))
                for k in range(n)]
    return [dict(os.environ, NCCL_HOSTID=f"chip-smoke-{k}",
                 NCCL_SOCKET_IFNAME="lo") for k in range(n)]


def drive_nccl(pileup):
    """Phase 20's process pair on the pileup file ``pileup``, each with a
    card of its own (own_card_envs): both exit 0 on the "nccl" route,
    each launched the pools' kernels once per block, process 0's merges
    bit-equal to the one-process merge (it fails otherwise). Returns its
    phase fields."""
    port = free_port()
    runs = run_pair([[sys.executable, os.path.abspath(__file__),
                      "--nccl-worker", str(k), str(port), pileup]
                     for k in range(2)], timeout=300, envs=own_card_envs())
    out = []
    for rc, stdout, stderr, secs in runs:
        if rc != 0:
            fail(f"nccl worker exited {rc}:\n{stderr[-3000:]}")
        res = json.loads(stdout.strip().splitlines()[-1])
        if res["route"] != "nccl" or any(
                p["route"] != "nccl" for p in res["genome_merge"]):
            fail(f"nccl worker: {json.dumps(res)}")
        out.append(dict(res, wall_s=secs))
    return out


def drive_multihost(pileup):
    """The multihost phase's process pair on the pileup file ``pileup``:
    both exit 0, each launched K2' and K3' once per block of its stripe
    and its genome half; process 0's comparisons held (it fails
    otherwise). Returns its phase fields."""
    port = free_port()
    runs = run_pair([[sys.executable, os.path.abspath(__file__),
                      "--multihost-worker", str(k), str(port), pileup]
                     for k in range(2)])
    out = []
    for rc, stdout, stderr, _ in runs:
        if rc != 0:
            fail(f"multihost worker exited {rc}:\n{stderr[-3000:]}")
        res = json.loads(stdout.strip().splitlines()[-1])
        if res["route"] != "host" or any(
                p["route"] != "host" for p in res["genome_merge"]):
            fail(f"multihost: processes on one card took the route "
                 f"{res['route']}, not host")
        for part in ("stripe", "genome"):
            n = res[part]["blocks"]
            if res[part]["launches"] != dict(k2=n, k3=n) or not n:
                fail(f"multihost: rank {res['rank']} {part} launches "
                     f"{res[part]['launches']} for {n} blocks")
        out.append(res)
    return out


def render_quantum(s: str) -> float:
    """Smallest rendered step of a printf-formatted number: one unit in
    the last printed decimal (fixed) or significant (e-notation) digit."""
    s = s.strip()
    if "e" in s or "E" in s:
        mant, _, exp = s.lower().partition("e")
        dec = len(mant.split(".")[1]) if "." in mant else 0
        return 10.0 ** (int(exp) - dec)
    dec = len(s.split(".")[1]) if "." in s else 0
    return 10.0 ** (-dec)


def rows_close(want_line, got_line, exact_cols=()):
    """Two rendered rows equal in the columns exact_cols and, elsewhere,
    to 1.5 rendering quanta per float field (tests/test_multihost.py's
    rule for more than two genome shards, whose sum adds in another
    order than one process's)."""
    cw, cg = want_line.split("\t"), got_line.split("\t")
    if len(cw) != len(cg) or any(cw[c] != cg[c] for c in exact_cols):
        return False
    for a, b in zip(cw, cg):
        if a == b:
            continue
        try:
            fa, fb = float(a), float(b)
        except ValueError:
            return False
        if abs(fa - fb) > 1.5 * max(render_quantum(a), render_quantum(b)):
            return False
    return True


def cli_procs(base, tmp, name, extra, genome, n=2, route="host",
              envs=None):
    """The port CLI as n processes (--num-shards n --shard-id k
    --dist-coordinator 127.0.0.1:<port>, each with --profile) against one
    process with the same options: process 0's .single, .sing2 (and .pair)
    byte-identical, .best too, or for genome shards after
    canonicalize_best (the shard sum may order mirrored alpha == 0.5 ties
    otherwise; raw equality reported); beyond two genome shards, the
    calls and ids of .best equal (columns 0, 5, 6, 8, 11, 12 after
    canonicalize_best) and every other field of the three files within
    1.5 rendering quanta (the n-way sum adds in another order); the other
    processes write nothing; each process's trace names K2' and K3';
    each process's NOTICE names the reduce-scatter's route ``route``;
    process k runs in the environment envs[k] (None: this one's).
    Returns the phase fields, with each process's wall seconds (start to
    exit), the seconds of its merge and its K2' and K3' launches."""
    import re

    from parity_utils import canonicalize_best

    want = run_cli(base, tmp, name + "_one", extra=extra)
    port = free_port()
    runs = run_pair([
        [sys.executable, "-m", "demuxlet_tpu_torch.cli"] + base + extra
        + ["--out", os.path.join(tmp, f"{name}{k}"), "--num-shards", str(n),
           "--shard-id", str(k), "--dist-coordinator", f"127.0.0.1:{port}",
           "--profile", os.path.join(tmp, f"{name}_trace{k}")]
        for k in range(n)], envs=envs)
    procs = []
    for k, (rc, _, stderr, secs) in enumerate(runs):
        if rc != 0:
            fail(f"CLI processes {name}: process {k} exited {rc}:\n"
                 f"{stderr[-3000:]}")
        traced = profile_trace_kernels(os.path.join(
            tmp, f"{name}_trace{k}", "torch_trace.json"))
        merge = re.search(r"Merge across \d+ processes: ([0-9.]+)s", stderr)
        took = re.search(r"reduce-scatter on the (\w+) route", stderr)
        procs.append(dict(process=k, wall_s=secs,
                          merge_s=merge and float(merge.group(1)),
                          route=took and took.group(1),
                          traced_kernels=traced))
    if not all(p["traced_kernels"].get("K2'")
               and p["traced_kernels"].get("K3'") and p["merge_s"] is not None
               and p["route"] == route for p in procs):
        fail(f"CLI processes {name}: {procs}")
    if [f for f in os.listdir(tmp) for k in range(1, n)
            if f.startswith(f"{name}{k}.")]:
        fail(f"CLI processes {name}: a process other than 0 wrote outputs")
    got = read_outputs(os.path.join(tmp, f"{name}0"))
    if sorted(got) != sorted(want):
        fail(f"CLI processes {name}: files {sorted(got)}, {sorted(want)}")
    raw = {ext: got[ext] == want[ext] for ext in want}
    if genome and n > 2:
        ok = True
        for ext in want:
            w, g = want[ext], got[ext]
            if ext == ".best":
                w, g = canonicalize_best(w), canonicalize_best(g)
            cols = (0, 5, 6, 8, 11, 12) if ext == ".best" else ()
            ok = ok and len(w) == len(g) and all(
                rows_close(a, b, cols) for a, b in zip(w, g))
    else:
        strict = [ext for ext in want if ext != ".best" or not genome]
        ok = all(raw[ext] for ext in strict) and canonicalize_best(
            got[".best"]) == canonicalize_best(want[".best"])
    if not ok:
        fail(f"CLI processes {name}: files equal to one process's: {raw}")
    return dict(case=name, processes=n, cells=len(want[".best"]) - 1,
                files=sorted(want), byte_identical=raw, per_process=procs)


# phase 8's option matrix: (case, options); None is the --group-list file
CLI_OPTIONS = (
    ("field GP", ["--field", "GP"]),
    ("field PL", ["--field", "PL"]),
    ("sm 6 of 8", [a for i in range(1, 7) for a in ("--sm", f"S{i}")]),
    ("group-list half", ["--group-list", None]),
    ("doublet-prior 0.3, 5 alphas",
     ["--doublet-prior", "0.3"] + [a for x in GRID for a in ("--alpha",
                                                             repr(x))]),
)


def cli_options_vs_parity(tmp, barcodes, kernels):
    """Phase 8's option matrix on the phase-5 BAM/VCF with GP and PL added
    (``cli_case``): per case of CLI_OPTIONS, the CLI with no --mode
    against --mode parity with the same options, as ``cli_vs_parity``
    holds them; --group-list names every other one of ``barcodes``. The
    parity runs are processes of their own, all started together. Returns
    one phase-field dict a case."""
    tmp = os.path.join(tmp, "options")
    os.makedirs(tmp)
    base = cli_case(tmp, V, 150, 80, fields=("GT", "GP", "PL"))
    groups = os.path.join(tmp, "groups.txt")
    with open(groups, "w") as fh:
        fh.write("".join(b + "\n" for b in sorted(barcodes)[::2]))
    cases = [(name, [groups if a is None else a for a in args])
             for name, args in CLI_OPTIONS]
    runs = run_pair(
        [[sys.executable, "-m", "demuxlet_tpu_torch.cli"] + base + args
         + ["--mode", "parity", "--out", os.path.join(tmp, f"parity{i}")]
         for i, (_, args) in enumerate(cases)],
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    out = []
    for i, ((name, args), (rc, _, stderr, secs)) in enumerate(
            zip(cases, runs)):
        if rc != 0:
            fail(f"CLI parity {name} exited {rc}:\n{stderr[-3000:]}")
        case_tmp = os.path.join(tmp, f"case{i}")
        os.makedirs(case_tmp)
        t0 = time.monotonic()
        cells, named = cli_vs_parity(
            base + args, case_tmp, kernels,
            parity=read_outputs(os.path.join(tmp, f"parity{i}")))
        out.append(dict(case=name, cells=cells, parity_s=secs,
                        exact_s=time.monotonic() - t0, launches=named))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.kernels import extras_exact as k6
    from demuxlet_tpu_torch.kernels import extras_fast as k4
    from demuxlet_tpu_torch.kernels import front_exact as k2
    from demuxlet_tpu_torch.kernels import pair_exact as k3
    from demuxlet_tpu_torch.kernels import pair_fast
    from demuxlet_tpu_torch.kernels import pair_tiled_exact as k7
    from demuxlet_tpu_torch.kernels import pair_tiled_fast as k5
    from demuxlet_tpu_torch.ops import pair_tiled as PT
    from demuxlet_tpu_torch.ops.front_exact import (
        front_exact,
        front_exact_plain,
    )
    from demuxlet_tpu_torch.ops.pair import pair_llks, pair_llks_plain
    from demuxlet_tpu_torch.ops.pair_exact import pair_exact, pair_exact_plain
    from demuxlet_tpu_torch.utils.device import resolve_device

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
    every = [pair_fast, k2, k3, k7, k6, k5, k4]  # every kernel module
    ptxas = {}
    for name, (lib_path, secs) in kbuild.build_all().items():
        entries = ptxas[name] = ptxas_summary(kbuild.ptxas_report(lib_path))
        phase("build", kernel=name, seconds=secs,
              library=os.path.relpath(lib_path, HERE), ptxas=entries)
        if name in ("pair_exact", "pair_tiled_exact", "pair_fast",
                    "pair_tiled_fast", "extras_exact", "extras_fast") and any(
                e.get("spill_stores", 1) or e.get("stack", 1)
                for e in entries):
            fail(f"{name}: ptxas reports spills or a stack frame: {entries}")

    # per kernel: max errors over its cases; ms, plain ms and bound at the
    # main path's shape
    kstat = {k: {"max_abs": 0.0, "max_rel": 0.0}
             for k in ("k1", "k2", "k3", "k4", "k5", "k6", "k7")}

    def record(key, case_is_main, aerr, rerr=None, widest=False,
               **at_main):
        s = kstat[key]
        s["max_abs"] = max(s["max_abs"], aerr)
        s["max_rel"] = None if rerr is None else max(s["max_rel"], rerr)
        if case_is_main:
            s.update(at_main)
        if widest:  # the V_WIDEST case's times, beside the main shape's
            s["v64"] = at_main

    # ---- 3. K1 against its plain version at the main path's shapes
    rng = np.random.default_rng(0)
    for name, B, S, nv, grid in (
        ("main", 2048, 1024, V, GRID),
        ("default_grid", 2048, 1024, V, [0.0, 0.5]),
        ("ragged", 40, 384, V, GRID),
        # 24 rounds of 16 alphas, 1601 t channels
        ("v1_a384", 64, 512, 1, np.linspace(0.0, 0.5, 384).tolist()),
        ("deep", 2048, 4096, V, GRID),  # the engine's deepest slot pad
    ):
        A = len(grid)
        t, gps_t, _, expand = pair_inputs(rng, B, S, grid, dev, nv)
        args = (t, gps_t, nv, A, grid[0] == 0.0, grid.index(0.5), expand)
        ab, z0 = [x.clone() for x in pair_llks(*args)]
        again = pair_llks(*args)
        torch.cuda.synchronize()
        pab, pz0 = pair_llks_plain(*args)
        err = max(rel_err(ab, pab), rel_err(z0, pz0))
        aerr = max(abs_err(ab, pab), abs_err(z0, pz0))
        if not (np.isfinite(err) and err <= TOL):
            fail(f"K1 {name}: max relative error {err} > {TOL}")
        plane = ab[..., grid.index(0.5)]
        if not (torch.equal(ab, again[0]) and torch.equal(z0, again[1])
                and torch.equal(plane, plane.transpose(1, 2))):
            fail(f"K1 {name}: two launches differ or the alpha == 0.5 "
                 "plane is not symmetric")
        del again, plane
        ms = median_ms(lambda: pair_llks(*args))
        plain_ms = median_ms(lambda: pair_llks_plain(*args))
        b_ms, b_by = bound(channel_ops(B, S, *pair_work(
                               nv, A, True, grid.index(0.5), False)),
                           4 * (t.numel() + gps_t.numel() + ab.numel()
                                + z0.numel()), "f32")
        phase("k1_vs_plain", case=name, B=B, S=S, V=nv, A=A, C=t.shape[0],
              max_rel_err=err, max_abs_err=aerr, tol=TOL,
              relaunch_bit_equal=True, sym_plane_exact=True, ms=ms,
              plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
              smem_bytes=pair_fast.smem_bytes(nv, A, grid[0] == 0.0))
        record("k1", name == "main", aerr, err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by)
        del t, gps_t, ab, z0, pab, pz0, args
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
        parity = run_cli(base, tmp, "parity", "parity",
                         extra=["--write-pair"])
        cells, named = fast_cli_vs_parity(base, tmp, parity, [pair_fast],
                                          absent=[k5, k4])
        phase("cli", mode="fast", cells=cells, samples=V,
              best_equal_parity=True, launches=named)

        # ---- 6. K2' and K3' against their plain versions
        rng = np.random.default_rng(3)
        for name, B, S, grid in (
            ("main", 2048, 1024, GRID),
            ("default_grid", 2048, 1024, [0.0, 0.5]),
            ("ragged", 40, 384, GRID),
            ("deep", 2048, 4096, GRID),  # the engine's deepest slot pad
            # the engine's lane profile as the exact path reads it
            ("lanes", 2048, 1024, GRID),
        ):
            A = len(grid)
            if name == "lanes":
                tab, codes, tail, n_deep, msk, g, lanes = \
                    lane_profile_inputs(rng, B, S, dev, grid)
            else:
                tab, codes, msk, g = exact_inputs(rng, B, S, grid, dev)
                tail, n_deep = None, 0
                lanes = dict(U=codes.shape[2], U0=codes.shape[2], K2p=0,
                             tail_entries=0)
            fargs = (codes, tab.lut, msk, tab.cmask, tab.gsel, tail, n_deep)
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
            b_ms, b_by = k2_bound(B, S, tab, codes, tail,
                                  lanes["tail_entries"], msk, t, gl)
            phase("k2_vs_plain", case=name, B=B, S=S, **lanes,
                  R=tab.lut.shape[0], C=tab.lut.shape[1], max_rel_err=err,
                  max_abs_err=aerr, tol=FRONT_TOL, ms=ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by)
            # the table's K2' row: the engine's lane profile
            record("k2", name == "lanes", aerr, err, ms=ms,
                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            pargs = (t, g, gl, V, A, grid[0] == 0.0, grid.index(0.5),
                     tab.expand)
            got = [x.clone() for x in pair_exact(*pargs)]
            again = pair_exact(*pargs)
            torch.cuda.synchronize()
            want = pair_exact_plain(*pargs)
            aerr = max(abs_err(x, y) for x, y in zip(got, want))
            err = max(rel_err(x, y) for x, y in zip(got, want))
            if not (np.isfinite(aerr) and aerr <= EXACT_TOL):
                fail(f"K3' {name}: max absolute error {aerr} > {EXACT_TOL}")
            plane = got[0][..., grid.index(0.5)]
            if not (all(torch.equal(x, y) for x, y in zip(got, again))
                    and torch.equal(plane, plane.transpose(1, 2))):
                fail(f"K3' {name}: two launches differ or the alpha == 0.5 "
                     "plane is not symmetric")
            del again, plane
            ms = median_ms(lambda: pair_exact(*pargs))
            plain_ms = median_ms(lambda: pair_exact_plain(*pargs))
            b_ms, b_by = bound(
                channel_ops(B, S, *pair_work(V, A, True, grid.index(0.5),
                                             True)),
                8 * (t.numel() + g.numel() + gl.numel()
                     + sum(x.numel() for x in got)), "f64")
            phase("k3_vs_plain", case=name, B=B, S=S, V=V, A=A,
                  C=t.shape[0], max_abs_err=aerr, max_rel_err=err,
                  tol=EXACT_TOL, relaunch_bit_equal=True,
                  sym_plane_exact=True, ms=ms, plain_ms=plain_ms,
                  bound_ms=b_ms, bound_by=b_by,
                  smem_bytes=k3.smem_bytes(V, A, t.shape[0], grid[0] == 0.0))
            record("k3", name == "main", aerr, err, ms=ms, plain_ms=plain_ms,
                   bound_ms=b_ms, bound_by=b_by)
            # the argument tuples hold the inputs too
            del tab, codes, tail, msk, g, t, gl, pt, pgl, got, want, fargs
            del pargs
        torch.cuda.empty_cache()

        # K3''s refused shapes: a V=1 pool of 200 alphas (C t channels
        # beyond its stages) takes K7' + K6'
        grid = np.linspace(0.0, 0.5, 200).tolist()
        tab, codes, msk, g = exact_inputs(rng, 2048, 512, grid, dev, 1)
        t, gl = front_exact(codes, tab.lut, msk, tab.cmask, tab.gsel)
        pargs = (t, g, gl, 1, 200, True, 199, tab.expand)
        if k3.k3_fits(1, 200, t.shape[0], True):
            fail(f"K3' takes V=1, A=200, C={t.shape[0]}: no routed case")
        for k in (k3, k7, k6):
            k.reset_launches()
        got = pair_exact(*pargs)
        torch.cuda.synchronize()
        counts = {k.__name__.rsplit(".", 1)[1]: k.launches
                  for k in (k3, k7, k6)}
        aerr = max(abs_err(x, y)
                   for x, y in zip(got, pair_exact_plain(*pargs)))
        if not (np.isfinite(aerr) and aerr <= EXACT_TOL) or list(
                counts.values()) != [0, 1, 1]:
            fail(f"K3' refused shape: max absolute error {aerr}, launches "
                 f"{counts}")
        phase("k3_route", B=2048, S=512, V=1, A=200, C=t.shape[0],
              k3_fits=False, launches=counts, max_abs_err=aerr,
              tol=EXACT_TOL)
        del tab, codes, msk, g, t, gl, got, pargs
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

        # --write-pair (run() on K2' + K3'): .pair, .single and .sing2
        # byte-identical to parity's; --profile: a trace naming them
        for k in every:
            k.reset_launches()
        wp = run_cli(base, tmp, "write_pair", extra=["--write-pair"])
        named = {k.__name__.rsplit(".", 1)[1]: k.launches for k in every}
        for ext in (".pair", ".single", ".sing2"):
            if wp[ext] != parity[ext]:
                fail(f"CLI --write-pair {ext} differs from parity's")
        if not (named["front_exact"] and named["pair_exact"]) or sum(
                named.values()) != named["front_exact"] + named["pair_exact"]:
            fail(f"CLI --write-pair launches {named}")
        trace_dir = os.path.join(tmp, "trace")
        run_cli(base, tmp, "profile", extra=["--profile", trace_dir])
        traced = profile_trace_kernels(
            os.path.join(trace_dir, "torch_trace.json"))
        if not (traced.get("K2'") and traced.get("K3'")):
            fail(f"CLI --profile trace names the kernels {traced}")
        phase("cli", mode="exact (default) --write-pair, --profile",
              cells=len(wp[".best"]) - 1, samples=V,
              pair_lines=len(wp[".pair"]),
              pair_single_sing2_byte_identical=True, launches=named,
              profile_trace_kernels=traced)

        # the input options, each against --mode parity with the same
        for fields in cli_options_vs_parity(
                tmp, [l.split("\t")[0] for l in parity[".best"][1:]],
                [k2, k3]):
            phase("cli", mode="exact (default)", samples=V,
                  single_sing2_byte_identical=True, best_equal_parity=True,
                  **fields)

    # ---- 9. K7' and K6' against their plain versions
    rng = np.random.default_rng(4)
    # and the engine's deepest slot pad
    for name, B, S, nv, grid in TILED_CASES + (
            ("deep", 2048, 4096, V_LARGE, GRID_LARGE),):
        A = len(grid)
        a0_sep, sym_a = grid[0] == 0.0, grid.index(0.5)
        tab, codes, msk, g = exact_inputs(rng, B, S, grid, dev, nv)
        t, gl = front_exact(codes, tab.lut, msk, tab.cmask, tab.gsel)
        del codes, msk
        plan = PT.plan_tiles(nv, A, a0_sep, sym_a)
        a7 = (t, g, nv, A, plan, tab.expand)
        a6 = (t, g, gl, nv, A, a0_sep, tab.expand)
        got7, got6 = PT.pair_tiled(*a7), PT.extras(*a6)
        again7, again6 = PT.pair_tiled(*a7), PT.extras(*a6)
        torch.cuda.synchronize()
        e7 = abs_err(got7, PT.pair_tiled_plain(*a7))
        e6 = abs_err(got6, PT.extras_plain(*a6))
        if not (np.isfinite(e7) and e7 <= EXACT_TOL
                and np.isfinite(e6) and e6 <= EXACT_TOL):
            fail(f"K7'/K6' {name}: max absolute errors {e7}, {e6} > "
                 f"{EXACT_TOL}")
        plane = got7[..., sym_a]
        if not (torch.equal(plane, plane.transpose(1, 2))
                and torch.equal(got7, again7) and torch.equal(got6, again6)):
            fail(f"K7'/K6' {name}: two launches differ or the alpha == 0.5 "
                 "plane is not symmetric")
        del again7, again6
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
              k6_max_abs_err=e6, tol=EXACT_TOL, relaunch_bit_equal=True,
              sym_plane_exact=True, k7_smem_bytes=k7.smem_bytes(plan.tile),
              k6_smem_bytes=k6.smem_bytes(nv, A, a0_sep), k7_ms=ms7,
              k7_plain_ms=plain7, k7_bound_ms=b7[0], k7_bound_by=b7[1],
              k6_ms=ms6, k6_plain_ms=plain6, k6_bound_ms=b6[0],
              k6_bound_by=b6[1])
        record("k7", name == "main", e7, widest=name == "v64", ms=ms7,
               plain_ms=plain7, bound_ms=b7[0], bound_by=b7[1])
        record("k6", name == "main", e6, widest=name == "v64", ms=ms6,
               plain_ms=plain6, bound_ms=b6[0], bound_by=b6[1])
        del tab, g, t, gl, got7, got6, plane, a7, a6
    torch.cuda.empty_cache()

    # ---- 10. the exact engine on a large pool: the same pileup scored
    # against 32 donors on the default grid (K2', K7', K6'; never K3')
    gps_large = gps_large_of()
    fields, counts = drive_engine(csr, gps_large, "exact", dev, [k2, k7, k6],
                                  grid=GRID_LARGE, absent=[k3])
    launches.update(k7=counts[k7], k6=counts[k6])
    phase("engine", mode="exact", k2_launches=counts[k2],
          k7_launches=counts[k7], k6_launches=counts[k6],
          k3_launches=counts[k3], card=card, **fields)

    # ---- 11. the CLI's default mode and fast mode on a large pool against
    # the oracle
    with tempfile.TemporaryDirectory() as tmp:
        base = cli_case(tmp, 16, 100, 40)
        parity = run_cli(base, tmp, "parity", "parity")
        cells, named = cli_vs_parity(base, tmp, [k2, k7, k6], absent=[k3],
                                     parity=parity)
        phase("cli", mode="exact (default)", cells=cells, samples=16,
              alphas=2, single_sing2_byte_identical=True,
              best_equal_parity=True, launches=named)
        cells, named = fast_cli_vs_parity(base, tmp, parity, [k5, k4],
                                          absent=[pair_fast])
        phase("cli", mode="fast", cells=cells, samples=16, alphas=2,
              best_equal_parity=True, launches=named)

    # ---- 12. K5' and K4' against their plain versions (phase 2 failed on
    # a spill or stack frame in either)
    k4_ptxas = [{k: e.get(k) for k in ("registers", "stack", "spill_stores")}
                for e in ptxas["extras_fast"]]
    rng = np.random.default_rng(6)
    # and the engine's deepest slot pad
    for name, B, S, nv, grid in TILED_CASES + (
            ("deep", 2048, 4096, V_LARGE, GRID_LARGE),):
        A = len(grid)
        a0_sep, sym_a = grid[0] == 0.0, grid.index(0.5)
        t, gps_t, gp0_t, expand = pair_inputs(rng, B, S, grid, dev, nv)
        plan = PT.plan_tiles(nv, A, a0_sep, sym_a)
        a5 = (t, gps_t, nv, A, plan, expand)
        a4 = (t, gps_t, gp0_t, nv, A, a0_sep, expand)
        got5, got4 = PT.pair_tiled_fast(*a5), PT.extras_fast(*a4)
        again5, again4 = PT.pair_tiled_fast(*a5), PT.extras_fast(*a4)
        torch.cuda.synchronize()
        want5, want4 = PT.pair_tiled_plain(*a5), PT.extras_fast_plain(*a4)
        e5, e4 = rel_err(got5, want5), rel_err(got4, want4)
        a5err, a4err = abs_err(got5, want5), abs_err(got4, want4)
        del want5, want4
        if not (np.isfinite(e5) and e5 <= TOL and np.isfinite(e4)
                and e4 <= TOL):
            fail(f"K5'/K4' {name}: max relative errors {e5}, {e4} > {TOL}")
        plane = got5[..., sym_a]
        if not (torch.equal(plane, plane.transpose(1, 2))
                and torch.equal(got5, again5) and torch.equal(got4, again4)):
            fail(f"K5'/K4' {name}: two launches differ or the alpha == 0.5 "
                 "plane is not symmetric")
        del again5, again4
        big = B * S * nv * nv * A > 1 << 30  # the plain versions take ~1 s
        ms5 = median_ms(lambda: PT.pair_tiled_fast(*a5))
        plain5 = median_ms(lambda: PT.pair_tiled_plain(*a5),
                           n=3 if big else 10)
        ms4 = median_ms(lambda: PT.extras_fast(*a4))
        plain4 = median_ms(lambda: PT.extras_fast_plain(*a4),
                           n=3 if big else 10)
        chans = sum(nv * (nv + 1) // 2 if a == sym_a else nv * nv
                    for a in plan.alist)
        b5 = bound(channel_ops(B, S, chans, nv * len(plan.alist)),
                   4 * (t.numel() + gps_t.numel() + got5.numel()), "f32")
        keys = PT.extras_keys(nv, A, a0_sep, singlets=False)
        b4 = bound(channel_ops(B, S, len(keys),
                               sum(k[0] == "m0" for k in keys)),
                   4 * (t.numel() + gps_t.numel() + gp0_t.numel()
                        + got4.numel()), "f32")
        phase("k5_k4_vs_plain", case=name, B=B, S=S, V=nv, A=A,
              C=t.shape[0], tile=plan.tile, tile_items=len(plan.items),
              k5_max_rel_err=e5, k5_max_abs_err=a5err, k4_max_rel_err=e4,
              k4_max_abs_err=a4err, tol=TOL, relaunch_bit_equal=True,
              sym_plane_exact=True, k5_smem_bytes=k5.smem_bytes(plan.tile),
              k4_smem_bytes=k4.smem_bytes(nv, A, a0_sep), k4_ptxas=k4_ptxas,
              k5_ms=ms5, k5_plain_ms=plain5, k5_bound_ms=b5[0],
              k5_bound_by=b5[1], k4_ms=ms4, k4_plain_ms=plain4,
              k4_bound_ms=b4[0], k4_bound_by=b4[1])
        record("k5", name == "main", a5err, e5, widest=name == "v64",
               ms=ms5, plain_ms=plain5, bound_ms=b5[0], bound_by=b5[1])
        record("k4", name == "main", a4err, e4, widest=name == "v64",
               ms=ms4, plain_ms=plain4, bound_ms=b4[0], bound_by=b4[1])
        del t, gps_t, gp0_t, got5, got4, plane, a5, a4
    torch.cuda.empty_cache()

    # ---- 13. the fast engine on the large pool (K5', K4'; never K1)
    fields, counts = drive_engine(csr, gps_large, "fast", dev, [k5, k4],
                                  grid=GRID_LARGE, absent=[pair_fast])
    launches.update(k5=counts[k5], k4=counts[k4])
    phase("engine", mode="fast", k5_launches=counts[k5],
          k4_launches=counts[k4], k1_launches=counts[pair_fast], card=card,
          **fields)

    # ---- 14. the full-tensor run() per mode and pool, beside run_compact
    for mode, g, grid, path in (
            ("exact", gps, GRID, [k2, k3]), ("fast", gps, GRID, [pair_fast]),
            ("exact", gps_large, GRID_LARGE, [k2, k7, k6]),
            ("fast", gps_large, GRID_LARGE, [k5, k4])):
        fields, _, eng, _ = drive_run(csr, g, mode, dev, path, every, grid)
        phase("run", mode=mode, card=card, **fields)
        if (mode, g.shape[1]) == ("exact", V):
            # ---- 15. run() with a spool directory, twice
            phase("spool", card=card, **spool_twice(eng, csr, every, dev))
        del eng
    torch.cuda.empty_cache()

    # ---- 16. the dense route on a cut pileup
    for fields in drive_dense(gps, dev, every):
        phase("dense", card=card, **fields)
    torch.cuda.empty_cache()

    # ---- 17. where the device time goes, per run
    for mode, g, grid in (("exact", gps, GRID), ("fast", gps, GRID),
                          ("exact", gps_large, GRID_LARGE),
                          ("fast", gps_large, GRID_LARGE)):
        phase("trace", card=card, **profile_engine(csr, g, mode, dev, grid))
    torch.cuda.empty_cache()

    # ---- 18. meshes: whole blocks per row (both members on this card),
    # and the dense route's slot axis
    runs = (("exact", gps, GRID, [k2, k3]), ("fast", gps, GRID, [pair_fast]),
            ("exact", gps_large, GRID_LARGE, [k2, k7, k6]),
            ("fast", gps_large, GRID_LARGE, [k5, k4]))
    n_cards = torch.cuda.device_count()
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    for devs in ([dev], cards) if n_cards >= 2 else ([dev],):
        for mode, g, grid, path in runs:
            phase("mesh", card=card, **drive_mesh(
                csr, g, mode, dev, path, every, grid, on_devices(2, 1, devs)))
            torch.cuda.empty_cache()
        for fields in drive_mesh_dense(gps, dev, every, devs):
            phase("mesh_dense", card=card, **fields)
        torch.cuda.empty_cache()
    if n_cards < 2:
        phase("mesh_two_cards", run=False, cards=n_cards,
              reason="this machine shows one CUDA device: the meshes above "
                     f"put every member on {dev}; a mesh over two cards was "
                     "not run")

    # ---- 19. two processes over gloo on this card
    with tempfile.TemporaryDirectory() as tmp:
        pileup = os.path.join(tmp, "pileup.npz")
        save_pileup(pileup, csr, gps)
        for fields in drive_multihost(pileup):
            phase("multihost", card=card, **fields)
        base = cli_case(tmp, V, 150, 80)
        for name, extra, genome, n in (
                ("barcode", [], False, 2),
                ("barcode_write_pair", ["--write-pair"], False, 2),
                ("genome", ["--shard-by", "genome"], True, 2),
                ("genome_write_pair", ["--shard-by", "genome",
                                       "--write-pair"], True, 2),
                ("barcode_p3", [], False, 3),
                ("genome_p4", ["--shard-by", "genome"], True, 4)):
            phase("multihost_cli", card=card,
                  **cli_procs(base, tmp, name, extra, genome, n))

        # ---- 20. the genome-shard reduce-scatter over NCCL, each process
        # with a card of its own (its own card, or on one card its own
        # NCCL_HOSTID)
        for fields in drive_nccl(pileup):
            phase("multihost_nccl", card=card, cards=n_cards, **fields)
        phase("multihost_nccl_cli", card=card, cards=n_cards,
              **cli_procs(base, tmp, "genome_nccl", ["--shard-by", "genome"],
                          True, route="nccl", envs=own_card_envs()))

    def row(key, name, source, replaces):
        s = kstat[key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": s["max_abs"], "max_rel_err": s["max_rel"],
                "ms": s["ms"], "plain_ms": s["plain_ms"],
                "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
                # the tiled kernels at V_WIDEST (B=2048, S=1024, A=2)
                "v64": s.get("v64"),
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
        row("k4", "extras_fast (K4')", src + "extras_fast.cu",
            jax + "pallas_pair.py:586"),
        row("k5", "pair_tiled_fast (K5')", src + "pair_tiled_fast.cu",
            jax + "pallas_pair.py:518"),
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
    if sys.argv[1:2] == ["--multihost-worker"]:
        sys.exit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]),
                                  sys.argv[4]))
    if sys.argv[1:2] == ["--nccl-worker"]:
        sys.exit(nccl_worker(int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4]))
    sys.exit(main())
