"""The slice as a whole: the port's fast-mode run_compact and CLI against
the JAX engine and CLI on the CPU, and the engine helpers the port copies
from the JAX module (``models/engine.py``, and the block format's in
``models/blocks.py``)."""

import dataclasses
import os
import random

import numpy as np
import pytest
import torch

from demuxlet_tpu.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu.models import engine as JE
from demuxlet_tpu_torch.models import blocks as TB
from demuxlet_tpu_torch.models import engine as TE
from demuxlet_tpu_torch.ops.front import fast_front
from demuxlet_tpu_torch.ops.wire import decode

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
    _, cfg = eng._kernel_setup(csr, None)
    tab = eng._tables("fast")
    blocks, pads = eng._blocks(csr.nbcs, csr)
    out = np.zeros((csr.nbcs, eng.nv, eng.nv, eng.n_alpha))
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        blk = eng._packer.pack(csr, cells, cfg, pad)
        _, _, ab, _ = fast_front(
            decode(TE._h2d(blk.bufs, CPU), blk.meta), tab, eng.n_alpha,
            eng.nv, a0_sep=True, sym_a=1)
        out[cells] = ab.numpy()[: len(cells)]
    return out


@pytest.mark.parametrize("wire,native", [("v1", True), ("v2", True),
                                         ("v2", False)])
def test_run_compact_matches_jax(monkeypatch, wire, native):
    """Port vs JAX fast run_compact on a PCR-hot pileup, with the native
    or the Python block packer, on the wire v2 and on the v1 forms (the
    port's past a slot limit cut below the pileup's blocks, the JAX
    engine's under its DEMUX_TPU_WIRE=v1): floats within 2e-5 relative,
    integer fields equal. The seed keeps every cell's competing values
    apart by more than that tolerance (asserted)."""
    from demuxlet_tpu.native import prep as nprep
    from demuxlet_tpu_torch.native import prep as tprep

    if wire == "v1":
        monkeypatch.setattr(TB, "SLOT_LIMIT", 127)
        monkeypatch.setenv("DEMUX_TPU_WIRE", "v1")
    else:
        monkeypatch.delenv("DEMUX_TPU_WIRE", raising=False)
    if not native:  # both engines on the Python packer
        monkeypatch.setattr(nprep, "available", lambda: False)
        monkeypatch.setattr(tprep, "available", lambda: False)
    elif not (nprep.available() and tprep.available()):
        pytest.skip("native prep not built")
    csr, gps = _pcr_hot_csr(17)
    grid = [0.0, 0.5]
    port = TE.DemuxEngine(gps, grid, cell_block=16, mode="fast", device=CPU)
    l_t, l0_t, c_t = port.run_compact(csr, doublet_prior=0.5)
    assert (port._cfg is None) == (wire == "v1")
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
    assert ([(f.name, f.type) for f in dataclasses.fields(TE.EngineResult)]
            == [(f.name, f.type) for f in dataclasses.fields(JE.EngineResult)])
    # _pad_block on the port's and the JAX package's build_slots blocks
    from demuxlet_tpu.host.slots import build_slots as j_build_slots
    from demuxlet_tpu_torch.host.slots import build_slots as t_build_slots

    for cells, n_cells, n_slots in ((list(range(5)), 8, 512),
                                    (list(range(16)), 16, None)):
        bt = t_build_slots(csr, cells, cap_bq=40)
        bj = j_build_slots(csr, cells, cap_bq=40)
        n_slots = n_slots or bt.idx.shape[1]
        pt = TE._pad_block(bt, n_cells, n_slots)
        pj = JE._pad_block(bj, n_cells, n_slots)
        for f in ("cell_ids", "idx", "msk", "cnt"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
        assert pt.idx.shape == (n_cells, n_slots)
    for n in (1, 8, 9, 200, 4097):
        assert TB._bucket(n) == JE._bucket(n)
        assert TB._bucket(n, 128) == JE._bucket(n, 128)
    port = TE.DemuxEngine(gps, [0.0, 0.5], cell_block=16, device=CPU)
    jax_eng = JE.DemuxEngine(gps, [0.0, 0.5], cell_block=16, mode="fast")
    blocks = port._blocks(csr.nbcs, csr)
    assert blocks[1] is not None  # the coverage sort engaged
    assert blocks == jax_eng._blocks(csr.nbcs, csr)
    assert port._blocks(40) == jax_eng._blocks(40)
    packer = port._packer
    cfg_t = packer.choose(csr)
    del csr._wire_cfg_cache
    # the port's own copy of host/wire.py: equal fields, another class
    assert cfg_t is not None and dataclasses.astuple(cfg_t) == \
        dataclasses.astuple(jax_eng._wire_cfg_for(csr))
    for a, b in zip(dataclasses.astuple(TE.cell_stats(csr)),
                    dataclasses.astuple(JE.cell_stats(csr))):
        np.testing.assert_array_equal(a, b)
    # block prep through the shape registry: identical bytes and metas
    blocks, pads = port._blocks(csr.nbcs, csr)
    for cells, pad in zip(blocks, pads or [None] * len(blocks)):
        got = packer.pack(csr, cells, cfg_t, pad)
        want = jax_eng._prep_codes_blk(csr, cells, pad)
        np.testing.assert_array_equal(got.bufs[0], want[0])
        assert len(got.bufs) == 1 and got.meta == want[1]
        assert want[2] is None
    assert packer._reg == jax_eng._wire_reg
    # the v1 forms: the port's past its slot limit, the JAX engine's under
    # DEMUX_TPU_WIRE=v1; neither is cached on the pileup
    del csr._wire_cfg_cache
    with monkeypatch.context() as m:
        m.setattr(TB, "SLOT_LIMIT", 127)
        m.setenv("DEMUX_TPU_WIRE", "v1")
        assert packer.choose(csr) is None
        assert jax_eng._wire_cfg_for(csr) is None
        assert not hasattr(csr, "_wire_cfg_cache")
        for cells, pad in zip(blocks, pads or [None] * len(blocks)):
            got = packer.pack(csr, cells, None, pad)
            codes, idx, msk = jax_eng._prep_codes_blk(csr, cells, pad)
            assert msk is None and isinstance(idx, tuple)
            wire, meta = JE._to_wire(codes, idx)
            np.testing.assert_array_equal(got.bufs[0], wire)
            assert len(got.bufs) == 1 and got.meta == ("v1", *meta)
    # _shrink_codes_blk (it writes markers into codes: give each a copy):
    # the u8 deltas fused into the v1 wire, and wide gaps as 16-bit pairs
    codes, idx, msk = build_codes_block(csr, list(range(32)), 40)
    for ids, form in ((idx, "v1"), (np.where(msk, idx * 200, 0), "u16")):
        ids = ids.astype(np.int32)
        got = TB._shrink_codes_blk((codes.copy(), ids.copy(), msk.copy()),
                                   port.gps.shape[0])
        want = jax_eng._shrink_codes_blk((codes.copy(), ids.copy(),
                                          msk.copy()))
        assert got.meta[0] == form and want[2] is None
        if form == "v1":
            wire, meta = JE._to_wire(want[0], want[1])
            np.testing.assert_array_equal(got.bufs[0], wire)
            assert got.meta == ("v1", *meta)
        else:
            for a, b in zip(got.bufs, want[:2]):
                np.testing.assert_array_equal(a, b)
            assert got.meta == ("u16", codes.shape[1])
    # tables: the same numbers the JAX engine puts on its device
    for c in (None, cfg_t):
        tab = TE.place(TE.host_tables(gps, [0.0, 0.5], 40, c), CPU)
        w_ext, logf_ext, expand = jax_eng._fast_tables(c)
        assert tab.expand == expand
        np.testing.assert_array_equal(tab.w_ext.numpy(), np.asarray(w_ext))
        np.testing.assert_array_equal(tab.logf_ext.numpy(),
                                      np.asarray(logf_ext))
        np.testing.assert_array_equal(tab.gps.numpy(),
                                      np.asarray(jax_eng._gps_dev, np.float32))
        np.testing.assert_array_equal(tab.gp0.numpy(),
                                      np.asarray(jax_eng._gp0_dev, np.float32))


@pytest.mark.parametrize("ns,nv", [(0, 3), (1, 2), (255, 5), (257, 14),
                                   (600, 64)])
def test_g_table_is_gps_and_gp0_rows(ns, nv):
    """The exact tables' g table, built channel-leading a few hundred SNPs
    a step, is bit for bit the (NS+1, 3V+3) table of the gps, their
    ``compute_gp0`` and the neutral column, transposed."""
    rng = np.random.default_rng(ns + nv)
    gps = TE._pad_gps(rng.random((ns, nv, 3)) ** 7)  # spread exponents
    n = gps.shape[0]
    want = np.zeros((n + 1, 3 * nv + 3))
    want[:n, :3 * nv] = gps.reshape(n, 3 * nv)
    want[:n, 3 * nv:] = TE.compute_gp0(gps)
    want[n, 0:3 * nv + 3:3] = 1.0
    got = TE.exact_host_tables(gps, [0.0, 0.5], 40, None).g_table.numpy()
    assert got.flags.c_contiguous
    assert got.tobytes() == np.ascontiguousarray(want.T).tobytes()


def test_engine_gp0_is_made_on_first_use():
    """An engine makes ``gp0`` only when asked for it (the dense route's
    tables), and then as ``compute_gp0`` makes it."""
    gps = np.random.default_rng(3).random((40, 4, 3))
    eng = TE.DemuxEngine(gps, [0.0, 0.5], device=CPU)
    assert "gp0" not in vars(eng)
    np.testing.assert_array_equal(eng.gp0, TE.compute_gp0(gps))
    assert "gp0" in vars(eng)


def test_engine_refuses_unported(monkeypatch):
    from demuxlet_tpu_torch.utils.logging_utils import DemuxError

    gps = np.full((10, 8, 3), 1 / 3)
    big = np.full((10, 14, 3), 1 / 3)  # V*V*A = 392 > 384
    # both modes take large pools: the tiled K5' + K4' and K7' + K6'
    assert TE.DemuxEngine(big, [0.0, 0.5], mode="fast",
                          device=CPU).mode == "fast"
    assert TE.DemuxEngine(big, [0.0, 0.5], device=CPU).mode == "exact"
    # cap-BQ > 126: exact mode takes the dense route, fast mode refuses
    assert TE.DemuxEngine(gps, [0.0, 0.5], cap_bq=127,
                          device=CPU).dense_reason.startswith("--cap-BQ 127")
    with pytest.raises(DemuxError, match="cap-BQ.*use --mode exact"):
        TE.DemuxEngine(gps, [0.0, 0.5], cap_bq=127, mode="fast", device=CPU)
    for kw in (dict(exact_kernel="cuda"), dict(dtype=torch.float16)):
        with pytest.raises(DemuxError):
            TE.DemuxEngine(gps, [0.0, 0.5], device=CPU, **kw)
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


@pytest.mark.parametrize("nv,cell_block", [(3, 2048), (3, 16), (17, 2048),
                                           (17, 16)])
def test_run_compact_same_with_each_block_packer(monkeypatch, nv,
                                                 cell_block):
    """One exact run_compact on the CPU gives the same outputs,
    ``h2d_bytes`` and ``counts`` with the wire-v2 packer of native/pack,
    with the pinned native packer (native/prep) in its place, and with no
    native prep (the numpy packer); native/pack packs every block of the
    first run and none of the others."""
    from demuxlet_tpu_torch.native import pack as tpack
    from demuxlet_tpu_torch.native import prep as tprep

    if tpack.counts() is None:
        pytest.skip("native prep not built")

    def run(packer):
        before = tpack.counts()
        with monkeypatch.context() as m:
            if packer == "pinned":
                m.setattr(TB.npack, "pack_block_v2", tprep.pack_block_v2)
            elif packer == "numpy":
                m.setenv("DEMUX_TPU_NO_NATIVE_PREP", "1")
                m.setattr(tprep, "_LIB", None)
                m.setattr(tprep, "_LOAD_FAILED", False)
            csr, gps = _pcr_hot_csr(41, n_cells=40, V=nv)
            eng = TE.DemuxEngine(gps, [0.0, 0.5], cell_block=cell_block,
                                 device=CPU)
            out = eng.run_compact(csr, doublet_prior=0.5)
            assert (eng._cfg is not None) and (
                tprep.available() == (packer != "numpy"))
        after = tpack.counts()
        return out, eng.h2d_bytes, dict(eng.counts), after[0] - before[0]

    (l_n, l0_n, c_n), h2d_n, counts_n, packed = run("native")
    assert packed == -(-40 // cell_block) and h2d_n > 0
    for packer in ("pinned", "numpy"):
        (l, l0, c), h2d, counts, packed = run(packer)
        assert packed == 0
        assert h2d == h2d_n and counts == counts_n, packer
        np.testing.assert_array_equal(l, l_n)
        np.testing.assert_array_equal(l0, l0_n)
        for f in dataclasses.fields(c):
            np.testing.assert_array_equal(getattr(c, f.name),
                                          getattr(c_n, f.name),
                                          err_msg=f"{packer} {f.name}")
