"""The benchmark's parts on the CPU: the generator repeats per seed, the
roofline counts do not see the engine's blocking, the reference fails a
corrupted output and its own float32 control, and nothing imports JAX or
the JAX package."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench_tiny import REPO, tiny_root

from portbench import compare, generator, harness, reference, roofline

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp("parts"))
    _, cfg, traffic, _, _ = harness.load_cell(root, "tiny8.tiny")
    return cfg, traffic


def _library(cfg, traffic, seed, index=0):
    gt, gps = generator.pool_gps(cfg, seed, CPU)
    return gps, generator.make_library(cfg, traffic, gt, seed, index, CPU)


def test_generator_repeats_per_seed(tiny):
    cfg, traffic = tiny
    seed = 2 ** 31 + 77
    gps1, a = _library(cfg, traffic, seed)
    gps2, b = _library(cfg, traffic, seed)
    _, c = _library(cfg, traffic, seed + 1)
    assert np.array_equal(gps1, gps2)
    for f in ("totl", "pass_", "uniq", "cell_ptr", "obs_snp", "obs_allele",
              "obs_bq"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f
    assert a.barcodes == b.barcodes and a.n_slots == b.n_slots
    assert not np.array_equal(a.obs_snp, c.obs_snp)
    assert a.barcodes != c.barcodes


def test_generator_emits_sorted_csr(tiny):
    cfg, traffic = tiny
    _, lib = _library(cfg, traffic, 12)
    n = lib.n_barcodes
    assert n == traffic["cells"] + traffic["empty"]
    assert len(set(lib.barcodes)) == n
    cell = np.repeat(np.arange(n), np.diff(lib.cell_ptr))
    key = cell.astype(np.int64) * cfg["snps"] + lib.obs_snp
    assert np.all(np.diff(key) >= 0)  # (cell, snp)-sorted, UMIs adjacent
    assert np.all(np.diff(lib.cell_ptr) >= 1)  # every droplet covers a SNP
    assert lib.n_slots == len(np.unique(key))
    assert lib.n_obs_real == int((lib.obs_allele < 2).sum())
    assert set(np.unique(lib.obs_bq)) <= set(traffic["bq"]["values"])
    assert np.all(lib.totl >= lib.pass_) and np.all(lib.pass_ >= lib.uniq)
    # every seed gets the same coverage targets, in another order
    t1 = generator.fixed_sizes(50, traffic["cell_coverage"], CPU)
    assert torch.equal(t1, torch.sort(t1).values)


def test_roofline_counts_the_engines_real_slots(tiny):
    """The work is counted over the covered (cell, SNP) slots that the
    engine's blocks hold, whatever the blocking, and not over the padded
    slot axis the blocks give the kernels."""
    from demuxlet_tpu_torch.host.csr import CsrPileup
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    cfg, traffic = tiny
    gps, lib = _library(cfg, traffic, 21)
    scl = CsrPileup(lib.sample_ids, lib.nsnps, lib.barcodes, lib.totl,
                    lib.pass_, lib.uniq, lib.cell_ptr, lib.obs_snp,
                    lib.obs_allele, lib.obs_bq)
    per_cell = np.asarray(scl.n_snps_all())
    padded, counts = [], []
    for block in (48, 64):  # 64 barcodes: 2 blocks of 48 cells, 1 of 64
        eng = DemuxEngine(gps, cfg["grid_alpha"], cell_block=block,
                          device=CPU)
        blocks, pads = eng._blocks(scl.nbcs, scl)
        assert sorted(c for b in blocks for c in b) == list(range(64))
        pads = pads or [max(-(-int(per_cell[b].max()) // 128) * 128, 128)
                        for b in blocks]
        padded.append(sum(block * p for p in pads))
        sizes = dict(cells=sum(len(b) for b in blocks),
                     slots=sum(int(per_cell[b].sum()) for b in blocks),
                     obs_real=lib.n_obs_real)
        assert sizes["slots"] == lib.n_slots  # what the harness counts
        counts.append([w(sizes, dict(cfg, cell_block=block)) for w in (
            roofline.front_work, roofline.pair_work_of,
            roofline.decision_work)])
    assert padded[0] != padded[1]  # the engine's padded slots move
    assert counts[0] == counts[1]  # the work counted does not
    assert counts[0][1][0] > 0 and counts[0][0][1] > 0


def test_roofline_bytes_are_inputs_and_outputs(tiny):
    """No stage counts what another stage hands it: the bytes of the three
    stages together are the job's inputs and its compact rows."""
    cfg, _ = tiny
    V, A = cfg["donors"], len(cfg["grid_alpha"])
    sizes = dict(cells=10, slots=300, obs_real=420)
    got = sum(w(sizes, cfg)[1] for w in (
        roofline.front_work, roofline.pair_work_of, roofline.decision_work))
    inputs = 420 + 2 * 4 * 300 + 8 * cfg["snps"] * 3 * V
    assert got == inputs + 8 * 10 * (2 * V + A + 11)


def _decided(lib, gps, cfg, dtype=torch.float64):
    ref = reference.llks(lib, gps, cfg, CPU, dtype=dtype)
    return reference.decide(ref, cfg, np.float64 if dtype == torch.float64
                            else np.float32)


def _rows(ref):
    keys = ("llk", "llk0", "sing_col", "llk_00", "max_llk", "sum_single",
            "sum_double", "i_sing1", "i_sing2", "max_sing2", "best_flat",
            "pair_llk12", "pair_llk10", "pair_llk20")
    return {k: np.array(ref[k], copy=True) for k in keys}


def test_reference_fails_corrupted_rows_and_its_control(tiny):
    cfg, traffic = tiny
    gps, lib = _library(cfg, traffic, 31)
    ref = _decided(lib, gps, cfg)
    V, A = cfg["donors"], len(cfg["grid_alpha"])
    limit = cfg["limits"]["rows_gap"]
    assert compare.rows_gap(_rows(ref), ref, V, A)[0] == 0.0
    # a cell whose best singlet leads the second by more than 1
    c = int(np.argmax(ref["sing_col"].max(1) - ref["max_sing2"]))
    bad = _rows(ref)
    bad["llk"][c, 0] += 1e-3
    assert compare.rows_gap(bad, ref, V, A)[0] > limit
    bad = _rows(ref)
    bad["i_sing1"][c] = bad["i_sing2"][c]
    bad["i_sing2"][c] = ref["i_sing1"][c]
    assert compare.rows_gap(bad, ref, V, A) > (limit, "")
    bad = _rows(ref)
    bad["best_flat"][c] = 0  # (0, 0, alpha 0): outside the doublet mask
    assert compare.rows_gap(bad, ref, V, A)[0] == float("inf")
    # the control: the same reference one precision lower
    low = _decided(lib, gps, cfg, torch.float32)
    assert compare.rows_gap(low, ref, V, A)[0] > 3 * limit


def test_render_check_counts_altered_lines(tiny):
    cfg, traffic = tiny
    gps, lib = _library(cfg, traffic, 41)
    ref = _decided(lib, gps, cfg)
    stats = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                 uniq=lib.uniq, nsnp=ref["nsnp"])
    rows = _rows(ref)
    text = ["\n".join(x) + "\n" for x in
            reference.render(rows, stats, lib.sample_ids, cfg)]
    assert compare.render_lines_off(text, rows, stats, lib.sample_ids,
                                    cfg) == 0
    lines = text[2].split("\n")
    lines[3] = lines[3].replace("\t", " ", 1)
    bad = [text[0], text[1], "\n".join(lines)]
    assert compare.render_lines_off(bad, rows, stats, lib.sample_ids,
                                    cfg) == 1
    short = [text[0], text[1], "\n".join(lines[:-3])]
    assert compare.render_lines_off(short, rows, stats, lib.sample_ids,
                                    cfg) >= 2


def test_program_matches_reference_text(tiny):
    """The port's own renderer on the reference's rows gives the
    reference's bytes (the render check's premise)."""
    from demuxlet_tpu_torch.models import decision, outputs

    cfg, traffic = tiny
    gps, lib = _library(cfg, traffic, 51)
    ref = _decided(lib, gps, cfg)
    rows = _rows(ref)
    stats_d = dict(barcodes=lib.barcodes, totl=lib.totl, pass_=lib.pass_,
                   uniq=lib.uniq, nsnp=ref["nsnp"])
    import io

    st = outputs.CellStats(lib.barcodes, lib.totl, lib.pass_, lib.uniq,
                           ref["nsnp"])
    comp = decision.CompactResult(**{k: rows[k] for k in (
        "sing_col", "llk_00", "max_llk", "sum_single", "sum_double",
        "i_sing1", "i_sing2", "max_sing2", "best_flat", "pair_llk12",
        "pair_llk10", "pair_llk20")})
    fs, f2, fb = io.StringIO(), io.StringIO(), io.StringIO()
    outputs.write_single(fs, st, lib.sample_ids, rows["llk"], rows["llk0"])
    outputs.write_pass2_compact(st, lib.sample_ids, comp, cfg["grid_alpha"],
                                cfg["doublet_prior"], f2, fb)
    text = (fs.getvalue(), f2.getvalue(), fb.getvalue())
    assert compare.render_lines_off(text, rows, stats_d, lib.sample_ids,
                                    cfg) == 0


FORBIDDEN_SOURCES = ("chip_smoke", "chip_steps", "bench", "benchmarks",
                     "tests", "fixtures", "oracle", "parity_utils")


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_no_old_bench():
    pb = os.path.join(REPO, "portbench")
    yard = ("reference.py", "compare.py", "generator.py", "roofline.py",
            "tracing.py")
    for dirpath, _, files in os.walk(pb):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tops = {m.split(".")[0] for m in _imports(path)}
            assert not harness.forbidden_modules(tops), path
            assert not tops & set(FORBIDDEN_SOURCES), path
            if f in yard and dirpath == pb:
                assert "demuxlet_tpu_torch" not in tops, path
            if os.path.basename(dirpath) == "tests":
                continue  # what run.py runs reads none of the old benches
            with open(path) as fh:
                src = fh.read()
            for name in ("chip_smoke.py", "bench.py", "benchmarks/"):
                assert name not in src, (path, name)


def test_top_level_names_compare_whole():
    assert harness.forbidden_modules(["demuxlet_tpu_torch.models.engine",
                                      "demuxlet_tpu_torch", "jaxtyping",
                                      "numpy"]) == []
    assert harness.forbidden_modules(["demuxlet_tpu.cli", "jax.numpy",
                                      "flax"]) == ["demuxlet_tpu", "flax",
                                                   "jax"]


def test_a_run_loads_no_jax(tiny, tmp_path):
    root = tiny_root(tmp_path)
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"sys.path.insert(0, {os.path.join(REPO, 'portbench', 'tests')!r})\n"
        "from portbench_tiny import run_tiny\n"
        f"rc, res, err = run_tiny({root!r})\n"
        "print(json.dumps([rc, res['correct'], sorted(sys.modules)]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc, correct, mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert rc == 0 and correct
    assert "demuxlet_tpu_torch" in mods
    assert harness.forbidden_modules(mods) == []
