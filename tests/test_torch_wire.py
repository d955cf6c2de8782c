"""Port wire decode (demuxlet_tpu_torch/ops/wire.decode) against the JAX
device decode (pallas_pair._unpack_wire_v2 / unpack_block_inputs):
bit-identical codes, ids, masks and tail entries on buffers from both the
Python packer and the native packer, at tail widths 16, 24 and 32, and on
every v1 block form the block packer (models/blocks.py) makes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from demuxlet_tpu.host import wire as W
from demuxlet_tpu.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu.ops import pallas_pair as PP
from demuxlet_tpu_torch.models import blocks as TB
from demuxlet_tpu_torch.ops import wire as TW

torch.set_num_threads(2)


def _csr(rng, n_cells, n_snps, hot_depth, nsnps_total=20_000):
    """CSR pileup: n_snps sorted distinct SNPs per cell, 1-2 UMIs per
    slot, allele==2 holes, and per cell two PCR-hot slots of depth
    hot_depth (deep UMI lanes -> the wire's sparse tail)."""
    obs = []
    for c in range(n_cells):
        snps = np.sort(rng.choice(nsnps_total, size=n_snps, replace=False))
        depth = 1 + (rng.random(n_snps) < 0.2)
        depth[rng.choice(n_snps, size=2, replace=False)] = hot_depth
        cells = np.full(int(depth.sum()), c)
        al = rng.integers(0, 3, size=len(cells))
        bq = np.where(rng.random(len(cells)) < 0.8, 37, 23)
        obs.append(np.stack([cells, np.repeat(snps, depth), al, bq], 1))
    obs = np.concatenate(obs)
    return CsrPileup.from_arrays(
        ["S0"], nsnps_total, ["B%03d" % i for i in range(n_cells)],
        np.zeros(n_cells), np.zeros(n_cells), np.zeros(n_cells),
        obs[:, 0], obs[:, 1], obs[:, 2].astype(np.uint8),
        obs[:, 3].astype(np.uint8),
    )


def _native():
    native = pytest.importorskip("demuxlet_tpu.native.prep")
    if not native.available():
        pytest.skip("native prep not built")
    return native


def _assert_v2_decoders_agree(buf, meta):
    """The parts agree with the JAX decoder's, and the full lanes rebuilt
    from them with its full lanes."""
    dense_t, tail_t, n_deep, idx_t, msk_t = TW.decode(
        (torch.from_numpy(buf),), meta)
    assert n_deep == meta[2] - meta[3]
    codes_j, idx_j, msk_j = PP._unpack_wire_v2(jnp.asarray(buf), meta)
    codes_t = dense_t if tail_t is None else TW.rebuild_lanes(
        dense_t, *tail_t, n_deep, meta[8] + 1)
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(msk_t.numpy(), np.asarray(msk_j))
    dense_j, tail_j, idx_j, msk_j = PP._unpack_wire_v2(
        jnp.asarray(buf), meta, parts=True)
    np.testing.assert_array_equal(dense_t.numpy(), np.asarray(dense_j))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(msk_t.numpy(), np.asarray(msk_j))
    assert (tail_t is None) == (tail_j is None)
    if tail_t is not None:
        for a, b in zip(tail_t, tail_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("tw,n_cells,n_snps,hot,cw,dw", [
    (16, 40, 60, 9, 4, 4),
    (16, 40, 60, 9, 6, 16),
    (24, 6, 1200, 40, 4, 8),
    (32, 4, 140, 300, 8, 6),
])
def test_v2_both_packers_decode_bit_identical(tw, n_cells, n_snps, hot, cw,
                                              dw):
    """The native and Python packers emit identical bytes; the port and
    JAX decoders give identical codes/idx/msk/tail from them."""
    rng = np.random.default_rng(tw + cw)
    csr = _csr(rng, n_cells, n_snps, hot)
    dict_codes = W.choose_cfg(csr, 40).dict_codes
    cfg = W.WireCfg(dict_codes, cw, dw, u_cap=1, adaptive=False)
    cells = list(range(n_cells))
    buf_p, meta_p = W.pack_wire_block(*build_codes_block(csr, cells, 40), cfg)
    assert meta_p[9] == tw, meta_p
    _assert_v2_decoders_agree(buf_p, meta_p)
    native = _native()
    buf_n, meta_n = native.pack_block_v2(csr, cells, cfg, cap_bq=40)
    assert meta_n == meta_p
    np.testing.assert_array_equal(buf_n, buf_p)
    _assert_v2_decoders_agree(buf_n, meta_n)


def test_native_tw24_big_s_deep_u_block():
    """Big-S deep-U block through the native packer with meta tw == 24:
    the C (slot u16, lane u8) planes and their pad sentinel are byte-
    identical to the Python packer's, and both decoders agree on them."""
    rng = np.random.default_rng(117)
    csr = _csr(rng, 10, 1270, 40)
    cfg = W.WireCfg(W.choose_cfg(csr, 40).dict_codes, 4, 8, u_cap=1,
                    adaptive=False)
    native = _native()
    buf_n, meta_n = native.pack_block_v2(csr, list(range(10)), cfg,
                                         cap_bq=40)
    S, U, U0, tw = meta_n[1], meta_n[2], meta_n[3], meta_n[9]
    assert tw == 24 and S * (U - U0) > 0xFFFF and U - U0 <= 255
    buf_p, meta_p = W.pack_wire_block(
        *build_codes_block(csr, list(range(10)), 40), cfg)
    assert meta_p == meta_n
    np.testing.assert_array_equal(buf_n, buf_p)
    _assert_v2_decoders_agree(buf_n, meta_n)


def _v1_forms():
    """{name: blocks.Block} of every v1 form the block packer makes."""
    rng = np.random.default_rng(5)
    csr = _csr(rng, 36, 150, 5, nsnps_total=3000)
    codes, idx, msk = build_codes_block(csr, list(range(36)), 40)

    def shrink(ids, n_snps):
        return TB._shrink_codes_blk((codes.copy(), ids.astype(np.int32),
                                     msk.copy()), n_snps)

    forms = {"v1_wire": shrink(idx, 3000)}
    # gaps past 255 between a cell's SNPs ride in the fix list
    forms["v1_wire_fixes"] = shrink(np.where(msk, idx * 3, 0), 9000)
    assert forms["v1_wire"].meta[0] == forms["v1_wire_fixes"].meta[0] == "v1"
    _, S, U, K = forms["v1_wire_fixes"].meta
    fix_val = forms["v1_wire_fixes"].bufs[0][:, (S * U + S) // 4 + 1 + K:]
    assert fix_val.any()
    # wide gaps defeat the u8 deltas: 16-bit id pairs in int32 lanes, or
    # the plain ids where the pool's SNPs pass 0xFFFF
    wide = np.where(msk, idx * 20, 0)
    forms["u16_pairs"] = shrink(wide, 60_000)
    forms["ids"] = shrink(wide, 70_000)
    assert forms["u16_pairs"].meta == ("u16", codes.shape[1])
    assert forms["u16_pairs"].bufs[1].shape[1] == codes.shape[1] // 2
    assert forms["ids"].meta == ("i32", codes.shape[1])
    return forms


@pytest.mark.parametrize("form", ["ids", "v1_wire_fixes", "v1_wire",
                                  "u16_pairs"])
def test_v1_forms_decode_bit_identical(form):
    """decode against the JAX decoder on each v1 form: the same codes
    (int32 dense lanes, no tail), ids and mask derived from the codes."""
    blk = _v1_forms()[form]
    if blk.meta[0] == "v1":
        args = (jnp.asarray(blk.bufs[0]), None, None, blk.meta[1:])
    else:
        args = (*map(jnp.asarray, blk.bufs), None, None)
    cj, ij, mj = PP.unpack_block_inputs(*args)
    dense, tail, n_deep, it, mt = TW.decode(
        tuple(map(torch.from_numpy, blk.bufs)), blk.meta)
    assert tail is None and n_deep == 0 and dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
