"""The slice as a whole: the port's fast-mode run_compact and CLI against
the JAX engine and CLI on the CPU, and the engine helpers the port copies
from the JAX module."""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from demuxlet_tpu.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu.models import engine as JE
from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops.front import fast_front

torch.set_num_threads(2)

CPU = torch.device("cpu")
TOL = 2e-5  # fast-mode contract, relative with scale max(1, |x|)
INT_FIELDS = ("i_sing1", "i_sing2", "best_flat")


def _pcr_hot_csr(seed, n_cells=48, NS=300, V=3, per_cell=(25, 60)):
    """tests/test_wire.py-style pileup: per_cell[0]..per_cell[1] SNPs per cell,
    1-4 UMIs per slot and one PCR-hot slot of depth 13-21 per cell (deep
    lanes)."""
    rng = np.random.default_rng(seed)
    obs = []
    for c in range(n_cells):
        snps = np.sort(rng.choice(NS, size=int(rng.integers(*per_cell)),
                                  replace=False))
        for j, s in enumerate(snps):
            depth = 1 + (rng.random() < 0.3) * int(rng.integers(1, 4))
            if j == 7:
                depth += int(rng.integers(12, 20))
            for _ in range(depth):
                obs.append((c, s, int(rng.random() < 0.5),
                            int(rng.integers(13, 41))))
    obs = np.asarray(obs, dtype=np.int64)
    csr = CsrPileup.from_arrays(
        [f"S{i}" for i in range(V)], NS,
        ["B%04d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )
    gps = rng.dirichlet(np.ones(3), size=(NS, V))
    return csr, gps


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


def _min_gap(vals):
    """Smallest relative gap between the two largest DISTINCT values per
    row (exact copies, the mirrored alpha=0.5 channels, are one value)."""
    gaps = []
    for row in vals:
        u = np.unique(row[np.isfinite(row)])
        if len(u) >= 2:
            gaps.append((u[-1] - u[-2]) / max(1.0, abs(u[-1])))
    return min(gaps)


def _port_llk_ab(eng, csr):
    """Full (n, V, V, A) LLKs of the port's front, block by block."""
    cfg = eng._wire_cfg_for(csr)
    tab = eng._fast_tables(cfg)
    blocks, pads = eng._blocks(csr.nbcs, csr)
    out = np.zeros((csr.nbcs, eng.nv, eng.nv, eng.n_alpha))
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        codes, idx, msk = eng._prep_codes_blk(csr, cells, pad)
        wire = None
        if isinstance(idx, tuple) and isinstance(idx[0], str):
            wire, idx = idx, None
        elif isinstance(idx, tuple):
            codes, wire = TE._to_wire(codes, idx)
            idx = None
        _, _, ab, _ = fast_front(
            torch.from_numpy(codes), idx, msk, tab.gps, tab.gp0, tab.w_ext,
            tab.logf_ext, eng.n_alpha, eng.nv, a0_sep=True, sym_a=1,
            expand=tab.expand, wire=wire)
        out[cells] = ab.numpy()[: len(cells)]
    return out


@pytest.mark.parametrize("wire,native", [("v1", True), ("v2", True),
                                         ("v2", False)])
def test_run_compact_matches_jax(monkeypatch, wire, native):
    """Port vs JAX fast run_compact on a PCR-hot pileup, with the native
    or the Python block packer: floats within 2e-5 relative, integer
    fields equal. The seed keeps every cell's competing values apart by
    more than that tolerance (asserted)."""
    from demuxlet_tpu.native import prep as nprep
    from demuxlet_tpu_torch.native import prep as tprep

    monkeypatch.setenv("DEMUX_TPU_WIRE", wire)
    if not native:  # both engines on the Python packer
        monkeypatch.setattr(nprep, "available", lambda: False)
        monkeypatch.setattr(tprep, "available", lambda: False)
    elif not (nprep.available() and tprep.available()):
        pytest.skip("native prep not built")
    csr, gps = _pcr_hot_csr(17)
    grid = [0.0, 0.5]
    port = TE.DemuxEngine(gps, grid, cell_block=16, mode="fast", device=CPU)
    l_t, l0_t, c_t = port.run_compact(csr, doublet_prior=0.5)
    assert (port._wire_cfg is None) == (wire == "v1")
    csr_j, _ = _pcr_hot_csr(17)  # own pileup: the cfg cache rides on it
    l_j, l0_j, c_j = JE.DemuxEngine(gps, grid, cell_block=16,
                                    mode="fast").run_compact(csr_j, 0.5)
    assert _rel(l_t, l_j) < TOL and _rel(l0_t, l0_j) < TOL
    for f in dataclasses.fields(c_j):
        got, want = getattr(c_t, f.name), getattr(c_j, f.name)
        assert got.dtype == want.dtype and got.shape == want.shape, f.name
        if f.name in INT_FIELDS:
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            assert _rel(got, want) < TOL, f.name
    # no near ties: the singlet top-2 and the doublet argmax are decided
    assert _min_gap(c_j.sing_col) > 10 * TOL
    sc = np.sort(c_j.sing_col, axis=1)
    assert _min_gap(sc[:, :-1]) > 10 * TOL  # the runner-up vs the third
    ab = _port_llk_ab(port, csr)
    msk = np.broadcast_to(TE.D.doublet_mask(3, 2), ab.shape)
    assert _min_gap(np.where(msk, ab, -np.inf).reshape(len(ab), -1)) > 10 * TOL


def test_copied_engine_helpers_equal_jax(monkeypatch):
    monkeypatch.delenv("DEMUX_TPU_WIRE", raising=False)
    # coverage skew, so that _blocks sorts and pads to pow2 buckets
    csr, gps = _pcr_hot_csr(5, n_cells=70, per_cell=(8, 290))
    np.testing.assert_array_equal(TE.compute_gp0(gps), JE.compute_gp0(gps))
    for n in (1, 8, 9, 200, 4097):
        assert TE._bucket(n) == JE._bucket(n)
        assert TE._bucket(n, 128) == JE._bucket(n, 128)
    port = TE.DemuxEngine(gps, [0.0, 0.5], cell_block=16, device=CPU)
    jax_eng = JE.DemuxEngine(gps, [0.0, 0.5], cell_block=16, mode="fast")
    blocks = port._blocks(csr.nbcs, csr)
    assert blocks[1] is not None  # the coverage sort engaged
    assert blocks == jax_eng._blocks(csr.nbcs, csr)
    assert port._blocks(40) == jax_eng._blocks(40)
    cfg_t = port._wire_cfg_for(csr)
    del csr._wire_cfg_cache
    # the port's own copy of host/wire.py: equal fields, another class
    assert cfg_t is not None and dataclasses.astuple(cfg_t) == \
        dataclasses.astuple(jax_eng._wire_cfg_for(csr))
    monkeypatch.setenv("DEMUX_TPU_WIRE", "v1")
    assert port._wire_cfg_for(csr) is None
    assert jax_eng._wire_cfg_for(csr) is None
    monkeypatch.delenv("DEMUX_TPU_WIRE")
    for a, b in zip(dataclasses.astuple(TE.cell_stats(csr)),
                    dataclasses.astuple(JE.cell_stats(csr))):
        np.testing.assert_array_equal(a, b)
    # block prep through the shape registry: identical bytes and metas
    blocks, pads = port._blocks(csr.nbcs, csr)
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        got = port._prep_codes_blk(csr, cells, pad)
        want = jax_eng._prep_codes_blk(csr, cells, pad)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert port._wire_reg == jax_eng._wire_reg
    # _shrink_codes_blk (it writes markers into codes: give each a copy)
    codes, idx, msk = build_codes_block(csr, list(range(32)), 40)
    got = port._shrink_codes_blk((codes.copy(), idx.copy(), msk.copy()))
    want = jax_eng._shrink_codes_blk((codes.copy(), idx.copy(), msk.copy()))
    np.testing.assert_array_equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        np.testing.assert_array_equal(a, b)
    assert got[2] is None and want[2] is None
    np.testing.assert_array_equal(TE._to_wire(got[0], got[1])[0],
                                  JE._to_wire(want[0], want[1])[0])
    # tables: the same numbers the JAX engine puts on its device
    cfg = port._wire_cfg_for(csr)
    for c in (None, cfg):
        tab = TE.tables_from_numpy(gps, [0.0, 0.5], 40, c, CPU)
        w_ext, logf_ext, expand = jax_eng._fast_tables(c)
        assert tab.expand == expand
        np.testing.assert_array_equal(tab.w_ext.numpy(), np.asarray(w_ext))
        np.testing.assert_array_equal(tab.logf_ext.numpy(),
                                      np.asarray(logf_ext))
        np.testing.assert_array_equal(tab.gps.numpy(),
                                      np.asarray(jax_eng._gps_dev, np.float32))
        np.testing.assert_array_equal(tab.gp0.numpy(),
                                      np.asarray(jax_eng._gp0_dev, np.float32))


def test_engine_refuses_unported(monkeypatch):
    from demuxlet_tpu_torch.utils.logging_utils import DemuxError

    gps = np.full((10, 8, 3), 1 / 3)
    big = np.full((10, 14, 3), 1 / 3)  # V*V*A = 392 > 384
    with pytest.raises(DemuxError, match="K4/K5.*item 13b"):
        TE.DemuxEngine(big, [0.0, 0.5], mode="fast", device=CPU)
    # exact mode takes the tiled K7' + K6'
    assert TE.DemuxEngine(big, [0.0, 0.5], device=CPU).mode == "exact"
    for mode in ("exact", "fast"):
        with pytest.raises(DemuxError, match="cap-BQ.*item 12"):
            TE.DemuxEngine(gps, [0.0, 0.5], cap_bq=127, mode=mode,
                           device=CPU)
    with pytest.raises(DemuxError, match="mode"):
        TE.DemuxEngine(gps, [0.0, 0.5], mode="parity", device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(DemuxError, match="CUDA"):
            TE.DemuxEngine(gps, [0.0, 0.5])


def test_cli_fast_best_equals_jax_cli(tmp_path):
    """Port CLI and JAX CLI, both --mode fast --device cpu on one BAM/VCF:
    equal BEST columns after canonicalize_best_line."""
    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli as tcli
    from fixtures import random_workload, write_bam, write_vcf
    from parity_utils import canonicalize_best_line

    contigs, names, variants, reads, _ = random_workload(
        random.Random(29), n_cells=24, n_snps=50, n_samples=4,
        reads_per_cell=70)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants, contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    base = ["--sam", bam, "--vcf", vcf, "--field", "GT", "--mode", "fast",
            "--device", "cpu", "--mesh", "none", "--alpha", "0",
            "--alpha", "0.25", "--alpha", "0.5"]

    def best(main, out):
        assert main(base + ["--out", str(tmp_path / out)]) == 0
        with open(str(tmp_path / out) + ".best") as fh:
            return [canonicalize_best_line(l).split("\t")[5]
                    for l in fh.read().splitlines()[1:]]

    port = best(tcli.main, "t")
    assert len(port) == 24
    assert port == best(jcli.main, "j")
    assert os.path.exists(str(tmp_path / "t.single"))


def test_run_compact_zero_cells():
    """An empty pileup (a BAM with headers only) gives empty results of
    the right shapes, not an error."""
    csr = CsrPileup.from_arrays(
        ["S0", "S1"], 10, [], np.zeros(0), np.zeros(0), np.zeros(0),
        np.zeros(0, np.int64), np.zeros(0, np.int64),
        np.zeros(0, np.uint8), np.zeros(0, np.uint8))
    for mode in ("exact", "fast"):
        eng = TE.DemuxEngine(np.full((10, 2, 3), 1 / 3), [0.0, 0.5],
                             mode=mode, device=CPU)
        llks, llk0s, comp = eng.run_compact(csr, 0.5)
        assert llks.shape == (0, 2) and llk0s.shape == (0,)
        assert comp.sing_col.shape == (0, 2) and comp.llk_00.shape == (0, 2)
        assert comp.best_flat.dtype == np.int64 and len(comp.best_flat) == 0
