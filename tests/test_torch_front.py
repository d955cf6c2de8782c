"""Port fast front (demuxlet_tpu_torch/ops/front.py) against the JAX
block step pallas_pair.demux_block_fast (Pallas in interpret mode) on the
same block and the same tables, for every shipped block form."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu.host import wire as W
from demuxlet_tpu.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu.ops import pallas_pair as PP
from demuxlet_tpu_torch.models import blocks as TB
from demuxlet_tpu_torch.models.engine import host_tables, place
from demuxlet_tpu_torch.ops import front as TF
from demuxlet_tpu_torch.ops.pair import pair_llks
from demuxlet_tpu_torch.ops.wire import decode

torch.set_num_threads(2)

V, NS = 3, 300


def _pileup(seed=17, n_cells=40):
    """CSR pileup with PCR-hot slots (deep UMI lanes), allele==2
    observations and a few cells without observations."""
    rng = np.random.default_rng(seed)
    obs = []
    for c in range(n_cells - 3):
        snps = np.sort(rng.choice(NS, size=int(rng.integers(20, 60)),
                                  replace=False))
        for j, s in enumerate(snps):
            depth = 1 + (rng.random() < 0.3) * int(rng.integers(1, 4))
            if j == 7:
                depth += int(rng.integers(12, 20))
            for _ in range(depth):
                obs.append((c, s, int(rng.integers(0, 3)),
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


def _block(form, csr, grid):
    """(blocks.Block, the JAX block step's (codes, idx, msk, wire), wire
    config) of one 40-cell block."""
    cells = list(range(csr.nbcs))
    codes_blk = build_codes_block(csr, cells, 40)
    if form == "v2_wire":
        auto = W.choose_cfg(csr, 40)
        cfg = W.WireCfg(auto.dict_codes, auto.code_w, 8, u_cap=2,
                        adaptive=False)
        buf, meta = W.pack_wire_block(*codes_blk, cfg)
        assert meta[4] > 0  # deep lanes ride the tail
        return TB.Block((buf,), meta), (buf, None, None, meta), cfg
    if form == "ids":
        # the form of a pool past 0xFFFF SNPs whose ids the u8 deltas
        # cannot carry: codes with the packer's marker, plain ids
        codes, idx, msk = codes_blk
        codes[msk & (codes == 255).all(axis=-1), 0] = 254
        blk = TB.Block((codes, idx), ("i32", codes.shape[1]))
        return blk, (codes, idx, None, None), None
    blk = TB._shrink_codes_blk(codes_blk, NS)
    assert blk.meta[0] == "v1"
    return blk, (blk.bufs[0], None, None, blk.meta[1:]), None


def _jx(x):
    if x is None:
        return None
    return jnp.asarray(x)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("form,grid", [
    ("v2_wire", [0.0, 0.5]),
    ("v2_wire", [0.0, 0.25, 0.5]),
    ("v1_wire", [0.0, 0.25, 0.5]),
    ("v1_wire", [0.0, 0.5]),
    ("ids", [0.1, 0.5]),
])
def test_front_matches_jax(form, grid):
    """llk, llk0, llk_ab, llk_00 within 1e-5 relative (scale max(1,|x|))
    of the JAX block step on identical tables; padded and masked slots
    see t == 1 and neutral genotype rows exactly."""
    csr, gps = _pileup()
    blk, jax_in, cfg = _block(form, csr, grid)
    tab = place(host_tables(gps, grid, 40, cfg), torch.device("cpu"))
    A = len(grid)
    a0_sep = grid[0] == 0.0
    sym_a = grid.index(0.5)
    codes, idx, msk, wire = jax_in
    want = PP.demux_block_fast(
        _jx(codes), _jx(idx), _jx(msk), jnp.asarray(tab.gps.numpy()),
        jnp.asarray(tab.gp0.numpy()), jnp.asarray(tab.w_ext.numpy()),
        jnp.asarray(tab.logf_ext.numpy()), A, V, interpret=True,
        a0_sep=a0_sep, sym_a=sym_a, expand=tab.expand, wire=wire,
    )
    seen = {}

    def spy(t, gps_t, *args):
        seen["t"], seen["g"] = t, gps_t
        return pair_llks(t, gps_t, *args)

    got = TF.fast_front(
        decode(tuple(map(torch.from_numpy, blk.bufs)), blk.meta), tab, A, V,
        a0_sep=a0_sep, sym_a=sym_a, pair_fn=spy,
    )
    for name, g, w in zip(("llk", "llk0", "llk_ab", "llk_00"), got, want):
        assert g.shape == tuple(w.shape), name
        assert _rel(g.numpy(), w) < 1e-5, name
    # slots without observations: exactly neutral
    n_slots = csr.n_snps_all()
    B, S = seen["t"].shape[1:]
    empty = np.ones((B, S), bool)
    for c, n in enumerate(n_slots):
        empty[c, :n] = False
    assert empty.any()
    assert bool((seen["t"][:, torch.from_numpy(empty)] == 1.0).all())
    g = seen["g"].view(V, 3, B, S)[:, :, torch.from_numpy(empty)]
    assert bool((g[:, 0] == 1.0).all()) and bool((g[:, 1:] == 0.0).all())


@pytest.mark.parametrize("form", ["ids", "v2_wire"])
def test_gather_channel_leading_equals_row_major(form):
    """The genotype rows the pair search receives, gathered channel-leading
    from the engine's (3V+3, NS+1) table (``fast_g_table``), equal bit for
    bit the row-major (B, S, 3V+3) gather and relayout the fast front took
    before; with the table set's g table or one built here."""
    csr, gps = _pileup()
    grid = [0.0, 0.5]
    blk, _, cfg = _block(form, csr, grid)
    tab = place(host_tables(gps, grid, 40, cfg), torch.device("cpu"))
    assert tab.g_table.shape == (3 * V + 3, NS + 1)
    parts = decode(tuple(map(torch.from_numpy, blk.bufs)), blk.meta)
    neutral = torch.zeros((1, 3 * V + 3))
    neutral[0, 0 : 3 * V : 3] = 1.0
    neutral[0, 3 * V] = 1.0
    rows = torch.cat([torch.cat([tab.gps.reshape(NS, 3 * V), tab.gp0], 1),
                      neutral])
    want = rows[torch.where(parts.msk, parts.idx, NS)].permute(2, 0, 1)
    for g_table in (tab.g_table, TF.fast_g_table(tab.gps, tab.gp0)):
        seen = {}

        def spy(t, gps_t, V_, A, a0_sep, sym_a, expand, gp0_t):
            seen["g"] = torch.cat([gps_t, gp0_t])
            return pair_llks(t, gps_t, V_, A, a0_sep, sym_a, expand, gp0_t)

        TF.fast_front(parts, dataclasses.replace(tab, g_table=g_table), 2, V,
                      a0_sep=True, sym_a=1, pair_fn=spy)
        assert torch.equal(seen["g"], want)
