#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (H100).

Drives the port's main path, fast-mode ``DemuxEngine.run_compact`` and the
CLI, at the full width of the repo's realistic configuration (V=8 donors,
the 5-point alpha grid, 50,000 SNPs, ~1,000 covered SNPs per cell,
--cell-block 2048), after building every kernel of that path from the
sources in this checkout and holding each against its plain PyTorch
version on the card. Phases, one line each:

  1. environment: torch/CUDA versions, the card's name and power limit;
  2. nvcc build of csrc/ (seconds);
  3. K1 against pair_llks_plain at the main-path shapes (max relative
     error, scale max(1, |x|), limit 2e-5; median ms of 20 launches each);
  4. run_compact on a synthetic 20,480-cell pileup (10 blocks of 2048),
     wire v2: K1 launch count == blocks, barcodes/s and phase seconds, and
     the first 2 blocks again with the plain pair search on the card;
  5. the CLI (--mode fast) on a BAM/VCF from tests/fixtures.py: its .best
     calls equal the host-oracle --mode parity calls.

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


def compare_rows(got, ref, nv, na, tol):
    """Engine rows vs plain-version rows of the same cells. Float fields
    within tol; integer fields equal unless their competing values lie
    within tol (counted as near ties). Returns (max rel err, near ties)."""
    from demuxlet_tpu_torch.models import decision as D

    gl, g0, gc = D.unpack_block(got, nv, na)
    rl, r0, rc = D.unpack_block(ref, nv, na)
    err = max(rel_err(torch.from_numpy(gl), torch.from_numpy(rl)),
              rel_err(torch.from_numpy(g0), torch.from_numpy(r0)))
    for k in ("sing_col", "llk_00", "max_llk", "max_sing2", "pair_llk12"):
        err = max(err, rel_err(torch.from_numpy(np.asarray(gc[k])),
                               torch.from_numpy(np.asarray(rc[k]))))
    ties = np.zeros(len(got), bool)
    rows = np.arange(len(got))
    sc = np.asarray(rc["sing_col"])
    for k in ("i_sing1", "i_sing2"):
        a, b = gc[k].astype(np.int64), rc[k].astype(np.int64)
        bad = a != b
        close = (np.abs(sc[rows, a] - sc[rows, b])
                 <= tol * np.maximum(1.0, np.abs(sc[rows, b])))
        if (bad & ~close).any():
            fail(f"{k} differs beyond a near tie in "
                 f"{int((bad & ~close).sum())} cells")
        ties |= bad
    bad = gc["best_flat"] != rc["best_flat"]
    close = (np.abs(gc["pair_llk12"] - rc["pair_llk12"])
             <= tol * np.maximum(1.0, np.abs(rc["pair_llk12"])))
    if (bad & ~close).any():
        fail(f"best_flat differs beyond a near tie in "
             f"{int((bad & ~close).sum())} cells")
    ties |= bad
    return err, int(ties.sum())


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a "
             "CUDA card")
    from demuxlet_tpu_torch.kernels import build as kbuild
    from demuxlet_tpu_torch.kernels import pair_fast
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models.engine import DemuxEngine, _h2d
    from demuxlet_tpu_torch.ops.pair import pair_llks, pair_llks_plain
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
    t0 = time.monotonic()
    lib_path = kbuild.build("pair_fast")
    phase("build", kernel="pair_fast", seconds=time.monotonic() - t0,
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

    # ---- 4. the engine's main path
    rng = np.random.default_rng(1)
    t0 = time.monotonic()
    csr = synth_pileup(rng, N_CELLS)
    gps = rng.dirichlet(np.ones(3), size=(NSNPS, V))
    t_gen = time.monotonic() - t0
    # warm-up on another pileup: builds the native packer, inits cuBLAS
    DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, device=dev).run_compact(
        synth_pileup(np.random.default_rng(2), CELL_BLOCK), 0.5)
    torch.cuda.synchronize()
    eng = DemuxEngine(gps, GRID, cell_block=CELL_BLOCK, device=dev)
    pair_fast.reset_launches()
    t0 = time.monotonic()
    llks, llk0s, comp = eng.run_compact(csr, 0.5)
    wall = time.monotonic() - t0
    launches = pair_fast.launches
    blocks, pads = eng._blocks(csr.nbcs, csr)
    if launches != len(blocks) or len(blocks) != N_CELLS // CELL_BLOCK:
        fail(f"K1 launched {launches} times for {len(blocks)} blocks")
    if not (np.isfinite(llks).all() and np.isfinite(llk0s).all()
            and np.isfinite(comp.pair_llk12).all()
            and llks.shape == (N_CELLS, V)):
        fail("engine outputs are not finite or have the wrong shape")
    cfg = eng._wire_cfg_for(csr)
    if cfg is None:
        fail("the engine run did not use wire v2")
    # the first 2 blocks again, with the plain pair search on the card
    tab = eng._fast_tables(cfg)
    dbl_w = torch.as_tensor(D.doublet_weights(V, GRID, 0.5),
                            dtype=torch.float64, device=dev)
    dbl_msk = torch.as_tensor(D.doublet_mask(V, len(GRID)), device=dev)
    got, ref = [], []
    for cells, pad in list(zip(blocks, pads or [None] * len(blocks)))[:2]:
        buf, meta, _ = eng._prep_codes_blk(csr, cells, pad)
        rows = D.compact_step_body(
            _h2d(buf, dev), None, None, tab.gps, tab.gp0, tab.w_ext,
            tab.logf_ext, dbl_w, dbl_msk, len(GRID), V, 0.5, a0_sep=True,
            sym_a=GRID.index(0.5), expand=tab.expand, wire=meta,
            pair_fn=pair_llks_plain,
        ).cpu().numpy()[: len(cells)]
        ref.append(rows)
        c = D.take(comp, np.asarray(cells))
        got.append(np.concatenate(
            [c.sing_col, c.llk_00]
            + [getattr(c, k).astype(np.float64)[:, None] for k in D._PACK_KEYS]
            + [llks[cells], llk0s[cells][:, None]], axis=1))
    err, ties = compare_rows(np.concatenate(got), np.concatenate(ref), V,
                             len(GRID), TOL)
    if not err <= TOL:
        fail(f"engine vs plain: max relative error {err} > {TOL}")
    phase("engine", cells=N_CELLS, blocks=len(blocks), k1_launches=launches,
          wire="v2", barcodes_per_s=N_CELLS / wall, seconds=wall,
          phase_s=eng.phase_s, h2d_bytes=eng.h2d_bytes, gen_s=t_gen,
          plain_check_cells=int(sum(len(b) for b in blocks[:2])),
          plain_max_rel_err=err, near_tie_cells=ties, card=card)

    # ---- 5. the CLI against the host oracle
    import random

    from demuxlet_tpu_torch import cli
    from fixtures import random_workload, write_bam, write_vcf
    from parity_utils import canonicalize_best_line

    with tempfile.TemporaryDirectory() as tmp:
        contigs, names, variants, reads, _truth = random_workload(
            random.Random(7), n_cells=300, n_snps=200, n_samples=V,
            reads_per_cell=80)
        vcf = write_vcf(os.path.join(tmp, "w.vcf"), names, variants,
                        contigs=contigs)
        bam = write_bam(os.path.join(tmp, "w.bam"), contigs, reads)
        base = ["--sam", bam, "--vcf", vcf, "--field", "GT"]

        def calls(mode):
            out = os.path.join(tmp, mode)
            if cli.main(base + ["--out", out, "--mode", mode]) != 0:
                fail(f"CLI --mode {mode} returned non-zero")
            with open(out + ".best") as fh:
                return [canonicalize_best_line(l).split("\t")[5]
                        for l in fh.read().splitlines()[1:]]

        pair_fast.reset_launches()
        fast = calls("fast")
        cli_launches = pair_fast.launches
        parity = calls("parity")
    if not fast or fast != parity or cli_launches < 1:
        fail(f"CLI fast calls differ from parity ({len(fast)} rows, "
             f"{sum(a != b for a, b in zip(fast, parity))} differ, "
             f"{cli_launches} K1 launches)")
    phase("cli", cells=len(fast), samples=V, best_equal_parity=True,
          k1_launches=cli_launches)

    print(json.dumps({"kernels": [{
        "name": "pair_fast (K1)",
        "route": "cuda",
        "source": "demuxlet_tpu_torch/csrc/pair_fast.cu",
        "replaces": "demuxlet_tpu/ops/pallas_pair.py:96",
        "launches": launches,
        "max_abs_err": k1["max_abs"],
        "max_rel_err": k1["max_rel"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
