"""The engine's wire-v2 block packer (native/pack.py over native/pack.cpp)
against the pinned native packer (native/prep.pack_block_v2, over
native/prep.cpp) and the numpy one (host/wire.pack_wire_block): the same
bytes and meta on generated blocks of every code width, delta width and
tail width, with delta escapes, pad cells and pad slots, pinned and
registry floors, slots 32 to 256 lanes deep, cells of allele 2 alone, cells
without observations and a one-cell block; the same dims statistics; None
where the pinned packer gives None; packs on concurrent threads; and the
counter of blocks packed."""

import dataclasses

import numpy as np
import pytest
import torch

from demuxlet_tpu_torch.host import wire as W
from demuxlet_tpu_torch.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu_torch.native import pack
from demuxlet_tpu_torch.native import prep

torch.set_num_threads(2)

BQ2 = (23, 37)  # four codes: code width 4 fits them
BQ_MID = tuple(range(13, 41))  # 56 codes: width 6
BQ_ALL = tuple(range(0, 41))  # 82 codes: width 8


def _csr(seed, slots, extra=0.3, hot=(0, 0), gap=(1, 9), bq=BQ2,
         allele2_cells=()):
    """A (cell, snp)-sorted pileup of len(slots) cells, cell c covering
    slots[c] SNPs at gaps drawn from [gap[0], gap[1]] after a first SNP in
    [0, 50); each slot 1 + Poisson(extra) observations, hot[0] slots over
    the pileup hot[1] observations deeper; alleles 0, 1, 2, but only 2 in
    the cells of allele2_cells; base qualities drawn from bq."""
    rng = np.random.default_rng(seed)
    slots = np.asarray(slots, dtype=np.int64)
    n, total = len(slots), int(slots.sum())
    first = np.zeros(total, dtype=bool)
    starts = np.cumsum(slots) - slots
    first[starts[slots > 0]] = True
    step = np.where(first, rng.integers(0, 50, size=total),
                    rng.integers(gap[0], gap[1] + 1, size=total))
    csum = np.cumsum(step)
    snp = csum - np.repeat(np.concatenate([[0], csum])[starts], slots)
    cell_of_slot = np.repeat(np.arange(n), slots)
    depth = 1 + rng.poisson(extra, size=total)
    if hot[0] and total:
        depth[rng.choice(total, size=min(hot[0], total), replace=False)] \
            += hot[1]
    nobs = int(depth.sum())
    obs_cell = np.repeat(cell_of_slot, depth)
    allele = rng.integers(0, 3, size=nobs).astype(np.uint8)
    allele[np.isin(obs_cell, allele2_cells)] = 2
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(obs_cell, minlength=n), out=ptr[1:])
    z = np.zeros(n, dtype=np.int64)
    return CsrPileup(
        sample_ids=["S0", "S1"], nsnps=int(snp.max(initial=0)) + 1,
        barcodes=["B%05d" % i for i in range(n)], cell_totl=z, cell_pass=z,
        cell_uniq=z, cell_ptr=ptr,
        obs_snp=np.repeat(snp, depth).astype(np.int32), obs_allele=allele,
        obs_bq=rng.choice(np.asarray(bq, np.uint8), size=nobs))


def _registry(key):
    """A shape registry's floors, as BlockPacker._pack_reg hands them."""
    return (2, 48, 24) if key[1] >= 4 else None


CASES = {
    # name: (_csr arguments, (code_w, delta_w, u_cap, adaptive),
    #        pack_block_v2 keywords)
    "cw4_dw4_escapes": (dict(seed=1, slots=[60] * 40, gap=(1, 40)),
                        (4, 4, 8, True), {}),
    "cw4_dw8_hot32": (dict(seed=2, slots=[80] * 30, hot=(5, 24)),
                      (4, 8, 8, True), {}),
    "cw6_dw16_u1": (dict(seed=3, slots=[45] * 33, extra=0.6, bq=BQ_MID),
                    (6, 16, 1, False), {}),
    "cw6_dw6_u2": (dict(seed=4, slots=[37] * 20, gap=(1, 90), bq=BQ_MID),
                   (6, 6, 2, False), {}),
    "cw8_dw6_hot64": (dict(seed=5, slots=[70] * 25, hot=(3, 50),
                           bq=BQ_ALL), (8, 6, 8, True), {}),
    "cw8_dw8_hot256": (dict(seed=6, slots=[90] * 12, hot=(4, 200),
                            bq=BQ_ALL), (8, 8, 8, True), {}),
    "cw16_dw4": (dict(seed=7, slots=[50] * 18, gap=(1, 30), bq=BQ_ALL),
                 (16, 4, 2, False), {}),
    # a slot's dense lanes in one 64-bit field, and past it (one field a
    # lane)
    "cw4_u16_lanes_64_bits": (dict(seed=24, slots=[40] * 20, hot=(4, 30)),
                              (4, 8, 16, False), {}),
    "cw8_u8_lanes_64_bits": (dict(seed=25, slots=[40] * 20, hot=(4, 12),
                                  bq=BQ_ALL), (8, 8, 8, False), {}),
    "cw8_u16_lanes_128_bits": (dict(seed=26, slots=[40] * 20, hot=(4, 30),
                                    bq=BQ_ALL), (8, 8, 16, False), {}),
    "cw6_u16_lanes_96_bits": (dict(seed=27, slots=[40] * 20, extra=2.0,
                                   hot=(4, 30), bq=BQ_MID,
                                   allele2_cells=(2, 7)),
                              (6, 8, 16, False), {}),
    "cw4_u32_lanes_128_bits": (dict(seed=28, slots=[300] * 6, extra=3.0,
                                    hot=(6, 60)), (4, 8, 32, False),
                               dict(pad_slots_to=512)),
    "cw16_u8_lanes_128_bits": (dict(seed=29, slots=[40] * 20, extra=1.5,
                                    hot=(4, 20), bq=BQ_ALL),
                               (16, 6, 8, False), {}),
    "tw24": (dict(seed=8, slots=[1270] * 10, hot=(20, 40)),
             (4, 8, 1, False), {}),
    "tw32": (dict(seed=9, slots=[140] * 4, hot=(8, 300), bq=BQ_MID),
             (6, 6, 1, False), {}),
    "escapes_past_kp_floor": (dict(seed=10, slots=[200] * 16, gap=(1, 300)),
                              (4, 4, 4, False),
                              dict(floors=(None, 16, 8))),
    "pad_cells_and_slots": (dict(seed=11, slots=[50] * 37, hot=(2, 9)),
                            (4, 8, 8, True),
                            dict(pad_slots_to=512, pad_cells_to=64)),
    "pad_cells_not_32": (dict(seed=12, slots=[30] * 9),
                         (4, 6, 2, False), dict(pad_cells_to=40)),
    "floors_pinned": (dict(seed=13, slots=[66] * 21, hot=(6, 20)),
                      (4, 8, 8, True), dict(floors=(2, 64, 32))),
    "floors_from_registry": (dict(seed=14, slots=[66] * 21, hot=(6, 20)),
                             (4, 8, 8, True), dict(floors_for=_registry)),
    "allele2_cells": (dict(seed=15, slots=[40] * 20, hot=(3, 12),
                           allele2_cells=(0, 3, 19)), (4, 8, 2, True), {}),
    "empty_rows": (dict(seed=16, slots=[0, 5, 0, 0, 30, 0, 17, 0]),
                   (4, 8, 8, True), {}),
    "all_rows_empty": (dict(seed=17, slots=[0, 0, 0]), (4, 8, 8, True), {}),
    "one_cell": (dict(seed=18, slots=[300], hot=(2, 40)),
                 (6, 8, 8, True), {}),
}


def _block(name):
    """(csr, cells, cfg, keywords) of a case."""
    ckw, (cw, dw, u_cap, adaptive), kw = CASES[name]
    csr = _csr(**ckw)
    dict_codes = W.choose_cfg(csr, 40).dict_codes
    cfg = W.WireCfg(dict_codes, cw, dw, u_cap=u_cap, adaptive=adaptive)
    return csr, list(range(csr.nbcs)), cfg, kw


@pytest.fixture
def native():
    if pack.counts() is None:
        pytest.skip("native prep not built")


def _dims(fn, csr, cells, cfg):
    """The dims array of pack (fn dmx_pack3_dims) or pinned (dmx_pack2_dims)
    on a block."""
    ids = np.asarray(cells, dtype=np.int64)
    out = np.full(4 + len(pack.CANDS), -1, dtype=np.int64)
    assert fn(csr.cell_ptr, csr.obs_snp, csr.obs_allele, ids, len(ids),
              (1 << cfg.delta_w) - 1, pack.CANDS, len(pack.CANDS), out) == 0
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pack_bytes_and_meta_equal_pinned_and_numpy(native, name):
    """pack_block_v2 gives the pinned native packer's wire, byte for byte,
    and meta; and the numpy packer's, but at code width 16, which the
    numpy packer has not."""
    csr, cells, cfg, kw = _block(name)
    before = pack.counts()
    got = pack.pack_block_v2(csr, cells, cfg, cap_bq=40, **kw)
    assert pack.counts() == (before[0] + 1, before[1])
    want = prep.pack_block_v2(csr, cells, cfg, cap_bq=40, **kw)
    assert got[1] == want[1]
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    np.testing.assert_array_equal(got[0], want[0])
    if name == "tw24":
        assert got[1][9] == 24
    elif name == "tw32":
        assert got[1][9] == 32
    elif name.startswith("cw8_dw8_hot256"):
        assert got[1][2] == 256
    if cfg.code_w == 16:
        return
    pad = {k: kw[k] for k in ("pad_slots_to", "pad_cells_to") if k in kw}
    codes_blk = build_codes_block(csr, cells, 40, **pad)
    floors = kw.get("floors")
    if "floors_for" in kw:
        floors = kw["floors_for"](codes_blk[0].shape[1:])
    numpy_wire, numpy_meta = W.pack_wire_block(*codes_blk, cfg,
                                               floors=floors)
    assert numpy_meta == got[1]
    np.testing.assert_array_equal(numpy_wire, got[0])


@pytest.mark.parametrize("name", list(CASES))
def test_dims_equal_pinned(native, name):
    """dmx_pack3_dims's statistics equal dmx_pack2_dims's: slot, lane and
    escape maxima, the unsorted flag and the tail maxima at every U0
    candidate up to 2^16."""
    csr, cells, cfg, _ = _block(name)
    lib = prep._load()
    got = _dims(lib.dmx_pack3_dims, csr, cells, cfg)
    want = _dims(lib.dmx_pack2_dims, csr, cells, cfg)
    np.testing.assert_array_equal(got, want)
    assert (got[4:] > 0).any() == (name not in ("all_rows_empty",))


def test_dims_refuses_other_candidates(native):
    """The histogram stands for the pinned compares only at the wrapper's
    candidates 1, 2, 4, ...: others are refused, the output untouched."""
    csr, cells, cfg, _ = _block("cw4_dw8_hot32")
    lib = prep._load()
    ids = np.asarray(cells, dtype=np.int64)
    for cands in ([1, 2, 3], [2, 4]):
        cands = np.asarray(cands, dtype=np.int64)
        out = np.full(4 + len(cands), -7, dtype=np.int64)
        assert lib.dmx_pack3_dims(csr.cell_ptr, csr.obs_snp, csr.obs_allele,
                                  ids, len(ids), 255, cands, len(cands),
                                  out) == 1
        assert (out == -7).all()


def test_fill_refuses_u0_below_1(native):
    """dmx_pack3_fill has no dense lane to mark at U0 < 1: it refuses the
    block, writes nothing and counts nothing."""
    csr, cells, cfg, _ = _block("cw4_dw8_hot32")
    lib = pack._lib()
    ids = np.asarray(cells, dtype=np.int64)
    wire = np.full((32, 64), -7, dtype=np.int32)
    before = pack.counts()
    assert lib.dmx_pack3_fill(csr.cell_ptr, csr.obs_snp, csr.obs_allele,
                              csr.obs_bq, ids, len(ids), 40, cfg.code_lut(),
                              cfg.n_real, 4, 8, 128, 1, 0, 16, 8, 16, 32,
                              wire, 64) == 1
    assert (wire == -7).all()
    assert pack.counts() == before


def _unsorted():
    csr = _csr(seed=20, slots=[30] * 6)
    a = int(csr.cell_ptr[2])
    snp = csr.obs_snp.copy()
    snp[a:a + 4] = snp[a:a + 4][::-1] + np.asarray([0, 0, 0, 900])
    return dataclasses.replace(csr, obs_snp=snp)


@pytest.mark.parametrize("fault", ["unsorted", "slots_past_u16",
                                   "slot_past_2_16_lanes"])
def test_none_where_pinned_is_none(native, fault):
    """An unsorted slice, more than 0xFFFF padded slots and a slot deeper
    than 2^16 lanes: both native packers give None, and the block counts as
    handed to the numpy packer; a sorted neighbour block packs."""
    if fault == "unsorted":
        csr = _unsorted()
    elif fault == "slots_past_u16":
        csr = _csr(seed=21, slots=[66_000, 3], extra=0.0, gap=(1, 1))
    else:
        csr = _csr(seed=22, slots=[4, 2], extra=0.0, hot=(1, 70_000))
    cfg = W.WireCfg(W.choose_cfg(csr, 40).dict_codes, 4, 8, u_cap=2,
                    adaptive=True)
    cells = list(range(csr.nbcs))
    before = pack.counts()
    assert pack.pack_block_v2(csr, cells, cfg, cap_bq=40) is None
    assert pack.counts() == (before[0], before[1] + 1)
    assert prep.pack_block_v2(csr, cells, cfg, cap_bq=40) is None
    if fault == "unsorted":  # the cells around the unsorted one
        for part in ([0, 1], [3, 4, 5]):
            got = pack.pack_block_v2(csr, part, cfg, cap_bq=40)
            want = prep.pack_block_v2(csr, part, cfg, cap_bq=40)
            assert got[1] == want[1]
            np.testing.assert_array_equal(got[0], want[0])


def test_threads_pack_concurrently(native):
    """The prefetch pool packs on several threads at once: every thread's
    blocks keep the pinned bytes, with no call refused by ctypes (the
    functions' types are set once, not while another thread converts)."""
    from concurrent.futures import ThreadPoolExecutor

    csr, cells, cfg, _ = _block("cw4_dw8_hot32")
    parts = [cells[i::3] for i in range(3)]
    want = [prep.pack_block_v2(csr, part, cfg, cap_bq=40) for part in parts]

    def packs(t):
        for k in range(150):
            got = pack.pack_block_v2(csr, parts[(t + k) % 3], cfg, cap_bq=40)
            ref = want[(t + k) % 3]
            assert got[1] == ref[1]
            np.testing.assert_array_equal(got[0], ref[0])

    import sys
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # threads switch inside the conversions
    try:
        with ThreadPoolExecutor(4) as ex:
            list(ex.map(packs, range(4)))
    finally:
        sys.setswitchinterval(old)


def test_counter_rises_by_the_blocks_of_a_run(native):
    """One run_compact on a CPU engine packs each of its blocks here, and
    hands none to the numpy packer."""
    from demuxlet_tpu_torch.models.engine import DemuxEngine

    csr = _csr(seed=23, slots=[20] * 50, hot=(4, 12))
    gps = np.random.default_rng(23).dirichlet(np.ones(3),
                                              size=(csr.nsnps, 3))
    eng = DemuxEngine(gps, [0.0, 0.5], cell_block=16,
                      device=torch.device("cpu"))
    before = pack.counts()
    eng.run_compact(csr, 0.5)
    assert pack.counts() == (before[0] + 4, before[1])  # 50 cells / 16
