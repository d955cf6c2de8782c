"""Port fast front (demuxlet_tpu_torch/ops/front.py) against the JAX
block step pallas_pair.demux_block_fast (Pallas in interpret mode) on the
same block and the same tables, for every shipped block form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu.host import wire as W
from demuxlet_tpu.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu.ops import pallas_pair as PP
from demuxlet_tpu_torch.models.engine import (
    DemuxEngine,
    _to_wire,
    tables_from_numpy,
)
from demuxlet_tpu_torch.ops import front as TF
from demuxlet_tpu_torch.ops.pair import pair_llks

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
    """(codes, idx, msk, wire, wire_cfg) of one 40-cell block."""
    cells = list(range(csr.nbcs))
    codes_blk = build_codes_block(csr, cells, 40)
    if form == "v2_wire":
        auto = W.choose_cfg(csr, 40)
        cfg = W.WireCfg(auto.dict_codes, auto.code_w, 8, u_cap=2,
                        adaptive=False)
        buf, meta = W.pack_wire_block(*codes_blk, cfg)
        assert meta[4] > 0  # deep lanes ride the tail
        return buf, None, None, meta, cfg
    if form == "explicit":
        return (*codes_blk, None, None)
    eng = DemuxEngine(np.zeros((NS, V, 3)), grid, device=torch.device("cpu"))
    codes, idx, _ = eng._shrink_codes_blk(codes_blk)
    assert isinstance(idx, tuple)
    if form == "v1_shrunk":
        return codes, idx, None, None, None
    buf, meta = _to_wire(codes, idx)
    return buf, None, None, meta, None


def _jx(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(jnp.asarray(e) for e in x)
    return jnp.asarray(x)


def _tx(x):
    if x is None:
        return None
    if isinstance(x, tuple):
        return tuple(torch.from_numpy(e) for e in x)
    return torch.from_numpy(x)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float((np.abs(x - ref) / np.maximum(1.0, np.abs(ref))).max())


@pytest.mark.parametrize("form,grid", [
    ("v2_wire", [0.0, 0.5]),
    ("v2_wire", [0.0, 0.25, 0.5]),
    ("v1_shrunk", [0.0, 0.5]),
    ("v1_wire", [0.0, 0.5]),
    ("explicit", [0.1, 0.5]),
])
def test_front_matches_jax(form, grid):
    """llk, llk0, llk_ab, llk_00 within 1e-5 relative (scale max(1,|x|))
    of the JAX block step on identical tables; padded and masked slots
    see t == 1 and neutral genotype rows exactly."""
    csr, gps = _pileup()
    codes, idx, msk, wire, cfg = _block(form, csr, grid)
    tab = tables_from_numpy(gps, grid, 40, cfg, torch.device("cpu"))
    A = len(grid)
    a0_sep = grid[0] == 0.0
    sym_a = grid.index(0.5)
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
        _tx(codes), _tx(idx), _tx(msk), tab.gps, tab.gp0, tab.w_ext,
        tab.logf_ext, A, V, a0_sep=a0_sep, sym_a=sym_a, expand=tab.expand,
        wire=wire, pair_fn=spy,
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


@pytest.mark.parametrize("form", ["explicit", "v2_wire"])
def test_gather_channel_leading_equals_row_major(form):
    """The genotype rows the pair search receives, gathered channel-leading
    from the engine's (3V+3, NS+1) table (``fast_g_table``), equal bit for
    bit the row-major (B, S, 3V+3) gather and relayout the fast front took
    before; with the table given or built in the call."""
    from demuxlet_tpu_torch.ops.wire import unpack_wire_v2

    csr, gps = _pileup()
    grid = [0.0, 0.5]
    codes, idx, msk, wire, cfg = _block(form, csr, grid)
    tab = tables_from_numpy(gps, grid, 40, cfg, torch.device("cpu"))
    assert tab.g_table.shape == (3 * V + 3, NS + 1)
    if wire is not None:
        _, _, idx_t, msk_t = unpack_wire_v2(_tx(codes), wire, parts=True)
    else:
        idx_t, msk_t = _tx(idx), _tx(msk)
    neutral = torch.zeros((1, 3 * V + 3))
    neutral[0, 0 : 3 * V : 3] = 1.0
    neutral[0, 3 * V] = 1.0
    rows = torch.cat([torch.cat([tab.gps.reshape(NS, 3 * V), tab.gp0], 1),
                      neutral])
    want = rows[torch.where(msk_t, idx_t, NS)].permute(2, 0, 1)
    for g_table in (tab.g_table, None):
        seen = {}

        def spy(t, gps_t, V_, A, a0_sep, sym_a, expand, gp0_t):
            seen["g"] = torch.cat([gps_t, gp0_t])
            return pair_llks(t, gps_t, V_, A, a0_sep, sym_a, expand, gp0_t)

        TF.fast_front(_tx(codes), _tx(idx), _tx(msk), tab.gps, tab.gp0,
                      tab.w_ext, tab.logf_ext, 2, V, a0_sep=True, sym_a=1,
                      expand=tab.expand, wire=wire, pair_fn=spy,
                      g_table=g_table)
        assert torch.equal(seen["g"], want)
