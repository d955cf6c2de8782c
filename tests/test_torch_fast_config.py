"""Fast mode on the 8- and 64-donor pools (the benchmark's
``kang8_a2_fast`` and ``kang64_a2_fast`` configurations) at a small size
on the CPU, through the benchmark's job (``portbench.harness.run_job``:
``DemuxEngine(mode="fast")``, ``run_compact``, the render; the unrolled
K1 on 8 donors, the tiled K5' + K4' on 64): the rows within the
configuration's ``rows_gap`` limit of the plain reference in every field
and the text the reference's rendering of them; the reference in bfloat16
and the faults the exact cells' tests plant each read above the limit;
the fast .best calls equal exact mode's but where exact mode's own LLKs of
the two choices lie within the limit (the CLI's "calls identical")."""

import json
import os

import numpy as np
import pytest
import torch

from parity_utils import canonicalize_best_line
from portbench import compare, generator, harness, reference

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
SEED = 2 ** 31 + 23
# per configuration: its cell block and the library's cells and median
# coverage at this size (the 64-donor pool's smaller, so that the plain
# K5' and K4' stay fast on the CPU), and the route its engine takes
POOLS = {
    "kang8_a2_fast": (64, 256, 250, "kernels K1 ("),
    "kang64_a2_fast": (32, 64, 100, "kernels K5' + K4' ("),
}


@pytest.fixture(scope="module", params=list(POOLS))
def pool(request):
    """(cfg, lib, gps, ref): a fast configuration as the benchmark has it
    but in smaller blocks (``POOLS``), one seeded library of its cells
    traffic cut to a few blocks of cells at a lower median coverage, and
    the float64 reference's decided rows."""
    torch.set_num_threads(2)
    block, cells, median, _ = POOLS[request.param]
    with open(os.path.join(REPO, "portbench", "configs",
                           request.param + ".json")) as fh:
        cfg = dict(json.load(fh), cell_block=block)
    with open(os.path.join(REPO, "portbench", "traffic",
                           "cells.json")) as fh:
        traffic = dict(json.load(fh), cells=cells)
    traffic["cell_coverage"] = dict(traffic["cell_coverage"], median=median)
    gt, gps = generator.pool_gps(cfg, SEED, CPU)
    lib = generator.make_library(cfg, traffic, gt, SEED, 0, CPU)
    ref = reference.decide(reference.llks(lib, gps, cfg, CPU, chunk=1 << 12),
                           cfg)
    return cfg, lib, gps, ref


def _job(lib, gps, cfg):
    rec, rows, texts = harness.run_job(lib, gps, cfg, CPU,
                                       harness.Spans(False))
    return rec, rows, texts


def _gap(rows, ref, cfg):
    return compare.rows_gap(rows, ref, cfg["donors"],
                            len(cfg["grid_alpha"]))


@pytest.fixture(scope="module")
def fast_job(pool):
    cfg, lib, gps, _ = pool
    return _job(lib, gps, cfg)


def test_fast_rows_within_the_limit(pool, fast_job):
    """The fast job's rows lie within the limit of the float64 reference
    in every field (rows_gap is the widest field's gap), are not the
    reference's to the bit (f32 was computed), and render as the
    reference renders them."""
    cfg, lib, _, ref = pool
    rec, rows, texts = fast_job
    assert rec["route"].startswith(POOLS[cfg["name"]][3])
    gap, field = _gap(rows, ref, cfg)
    assert 0.0 < gap <= cfg["limits"]["rows_gap"], field
    stats = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                 uniq=lib.uniq, nsnp=ref["nsnp"])
    assert compare.render_lines_off(texts, rows, stats, lib.sample_ids,
                                    cfg) == 0


def _faulty_step(monkeypatch, fault):
    """Break the fast block step the job runs, as the exact cells' tests
    break the exact one."""
    from demuxlet_tpu_torch.models import decision

    real = decision.compact_step_body

    def broken(*args, **kw):
        rows = real(*args, **kw)
        out = rows.clone()
        if fault == "zeros":
            return torch.zeros_like(rows)
        if fault == "block_mean":
            half = rows.shape[0] // 2
            out[half:] = rows[:half].mean(dim=0)
        else:  # one LLK of one cell altered where produced
            out[0, 0] += 0.5
        return out

    monkeypatch.setattr(decision, "compact_step_body", broken)


@pytest.mark.parametrize("fault", ["bfloat16", "zeros", "block_mean", "llk",
                                   "call"])
def test_control_and_faults_read_above_the_limit(pool, fast_job,
                                                 monkeypatch, fault):
    """The reference computed in bfloat16 (one precision below the
    configuration's float32, decided in float32), a step that returns
    zeros, one that returns a block's mean for half its cells, one LLK
    altered by 0.5, and a best singlet swapped with the second: each reads
    above the limit."""
    cfg, lib, gps, ref = pool
    limit = cfg["limits"]["rows_gap"]
    if fault == "bfloat16":
        rows = reference.decide(
            reference.llks(lib, gps, cfg, CPU, dtype=torch.bfloat16,
                           chunk=1 << 12), cfg, dtype=np.float32)
    elif fault == "call":
        rows = {k: np.array(v, copy=True) for k, v in fast_job[1].items()}
        c = int(np.argmax(ref["sing_col"].max(1) - ref["max_sing2"]))
        rows["i_sing1"][c], rows["i_sing2"][c] = (rows["i_sing2"][c],
                                                  rows["i_sing1"][c])
    else:
        _faulty_step(monkeypatch, fault)
        rows = _job(lib, gps, cfg)[1]
    assert _gap(rows, ref, cfg)[0] > limit


def _rel(x, y):
    return abs(x - y) / max(1.0, abs(y))


def _calls(rows, lib, cfg, nsnp):
    """The BEST column of the rows' .best lines, mirrored alpha=0.5 pairs
    in one order (``parity_utils.canonicalize_best_line``), cell by
    cell."""
    stats = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                 uniq=lib.uniq, nsnp=nsnp)
    best = reference.render(rows, stats, lib.sample_ids, cfg)[2]
    by_bc = {line.split("\t")[0]: canonicalize_best_line(line).split("\t")[5]
             for line in best[1:]}
    return [by_bc.get(bc) for bc in lib.barcodes]


def _choice_gap(e, f, ab, c, V, A):
    """The least relative gap, in exact mode's LLKs of cell c (its rows e
    and full LLKs ab), between the choices its call rests on where fast
    mode's rows f chose otherwise: the best and second singlet, the best
    doublet, and the call's thresholds."""
    sing = e["sing_col"][c]
    gaps = [_rel(sing[e[k][c]], sing[f[k][c]])
            for k in ("i_sing1", "i_sing2") if e[k][c] != f[k][c]]
    flat = ab[c].reshape(-1)
    if e["best_flat"][c] != f["best_flat"][c]:
        gaps.append(_rel(flat[e["best_flat"][c]], flat[f["best_flat"][c]]))
    b = int(e["best_flat"][c])
    jb, kb = b // (V * A), (b // A) % V
    p12, llk1 = e["pair_llk12"][c], sing[e["i_sing1"][c]]
    gaps += [_rel(p12, sing[jb]), _rel(p12, sing[kb]), _rel(p12, llk1 + 2),
             _rel(llk1, e["max_sing2"][c] + 2)]
    return min(gaps)


def test_fast_calls_equal_exact_calls(pool, fast_job):
    """Every cell's fast call (singlet, or doublet pair and alpha, or
    ambiguous) equals exact mode's, but where exact mode's LLKs of the two
    choices the call rests on lie within the limit of each other."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    cfg, lib, gps, ref = pool
    V, A = cfg["donors"], len(cfg["grid_alpha"])
    exact_cfg = dict(cfg, mode="exact")
    _, exact, _ = _job(lib, gps, exact_cfg)
    scl = CsrPileup(lib.sample_ids, lib.nsnps, lib.barcodes, lib.totl,
                    lib.pass_, lib.uniq, lib.cell_ptr, lib.obs_snp,
                    lib.obs_allele, lib.obs_bq)
    ab = DemuxEngine(gps, cfg["grid_alpha"], cap_bq=cfg["cap_bq"],
                     cell_block=cfg["cell_block"], mode="exact",
                     device=CPU).run(scl).llk_ab
    fast = fast_job[1]
    want = _calls(exact, lib, cfg, ref["nsnp"])
    got = _calls(fast, lib, cfg, ref["nsnp"])
    assert len(got) == lib.n_barcodes and None not in got
    assert any(c.startswith("DBL-") for c in want)
    assert any(c.startswith("SNG-") for c in want)
    limit = cfg["limits"]["rows_gap"]
    for c in np.flatnonzero([g != w for g, w in zip(got, want)]):
        assert _choice_gap(exact, fast, ab, c, V, A) < limit, (
            c, got[c], want[c])


def test_engine_route_and_tile_items(pool):
    """The engine's route and its tiled pair kernel's work at the
    configuration's pool: on 64 donors K5' + K4' (never K1) over the
    symmetric plane's 10 upper-triangle 16-tiles, ``pair_tile_items``
    counting the plan's items for every block shipped; on 8 donors K1 and
    no tile item."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from demuxlet_tpu_torch.models.engine import DemuxEngine
    from demuxlet_tpu_torch.ops.pair_tiled import plan_tiles

    cfg, lib, gps, _ = pool
    V, grid = cfg["donors"], cfg["grid_alpha"]
    scl = CsrPileup(lib.sample_ids, lib.nsnps, lib.barcodes, lib.totl,
                    lib.pass_, lib.uniq, lib.cell_ptr, lib.obs_snp,
                    lib.obs_allele, lib.obs_bq)
    eng = DemuxEngine(gps, grid, cap_bq=cfg["cap_bq"],
                      cell_block=cfg["cell_block"],
                      slot_chunk=cfg["slot_chunk"], mode=cfg["mode"],
                      device=CPU)
    eng.run_compact(scl, cfg["doublet_prior"])
    assert eng.route.startswith(POOLS[cfg["name"]][3])
    plan = plan_tiles(V, len(grid), grid[0] == 0.0, grid.index(0.5))
    blocks = -(-lib.n_barcodes // cfg["cell_block"])
    if V == 64:
        assert (plan.tile, len(plan.items), plan.alist) == (16, 10, (1,))
        assert eng.counts["pair_tile_items"] == blocks * len(plan.items)
        # the (3V+3, B, S) f32 g rows of every block's shipped slots
        assert eng.counts["g_bytes"] == (3 * V + 3) * 4 * eng.counts[
            "slots_kernel"]
    else:
        assert plan is None and eng.counts["pair_tile_items"] == 0
