"""The kernel route's block format: the per-run choice of format and the
packing of each block on the host (port of the JAX engine's
``_wire_cfg_for``, ``_prep_codes_blk``, ``_pack_reg``,
``_shrink_codes_blk`` and ``_to_wire``, ``demuxlet_tpu/models/engine.py``,
whose module imports JAX; tests/test_torch_engine.py holds them to the
originals).

A run's blocks all take one format, chosen once per pileup
(``BlockPacker.choose``): the wire v2 of ``host/wire.py`` (the run's code
dictionary, bit-packed lanes and a deep-lane tail), or the v1 forms where
some cell covers so many SNPs that a block could pad past the v2's u16
slot positions. ``BlockPacker.pack`` makes one block, with the native
packers (the wire v2's ``native/pack.py``, the v1 forms' ``native/prep.py``)
where they load, else in numpy, as a ``Block``:
the host buffers to ship and a meta that names the form:

* ``("w2", S, U, U0, K2p, Kp, code_w, delta_w, n_real, tail_w)``: one
  (B, W) int32 buffer, the wire v2;
* ``("v1", S, U, K)``: one (B, W) int32 buffer of the u8 codes, the u8
  slot-id deltas, the base ids and K fixes (``_to_wire``);
* ``("u16", S)``: the u8 codes (B, S, U) and the slot ids as 16-bit pairs
  in (B, S/2) int32 lanes;
* ``("i32", S)``: the u8 codes and the (B, S) int32 slot ids.

The v1 forms ship no mask: 255 is no code, and 254 in lane 0 marks a
covered slot without codes. ``ops/wire.decode`` reads every form on the
device.
"""

from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np

from demuxlet_tpu_torch.host import wire as W
from demuxlet_tpu_torch.host.csr import build_codes_block
from demuxlet_tpu_torch.native import pack as npack
from demuxlet_tpu_torch.native import prep as nprep
from demuxlet_tpu_torch.utils.spans import span

# the v2 wire addresses a block's slots by u16 positions: a pileup whose
# blocks could pad past this many slots runs on the v1 forms
SLOT_LIMIT = 0xFFFF


class Block(NamedTuple):
    bufs: tuple  # the host arrays to ship, as they are
    meta: tuple  # the form's name and shape (the module docstring)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


def _to_wire(codes, idx_tuple) -> Block:
    """Fuse (codes, delta-idx) into ONE (B, W) int32 wire buffer (the v1
    wire; unpacked on device by bitcast)."""
    d8, base, fix_pos, fix_val = idx_tuple
    B, S, U = codes.shape
    K = fix_pos.shape[1]
    wire = np.concatenate(
        [
            codes.reshape(B, S * U).view(np.int32),
            d8.view(np.int32),
            base[:, None],
            fix_pos,
            fix_val,
        ],
        axis=1,
    )
    return Block((wire,), ("v1", S, U, K))


def _shrink_codes_blk(codes_blk, n_snps: int) -> Block:
    """A v1 block from the explicit (codes, idx, msk): msk is dropped (the
    device derives it from codes != 255; valid slots without codes carry
    the marker 254 in lane 0), and slot ids ship as u8 deltas with a
    sparse fix list in the fused wire when they can, else as 16-bit pairs
    packed into int32 lanes when the n_snps ids fit, else as they are."""
    codes, idx, msk = codes_blk
    empty = msk & (codes == 255).all(axis=-1)
    if empty.any():
        b, s = np.nonzero(empty)
        codes[b, s, 0] = 254
    S = idx.shape[1]
    d = np.zeros_like(idx, dtype=np.int64)
    d[:, 1:] = np.diff(idx.astype(np.int64), axis=1)
    d[~msk] = 0
    d[:, 1:][~msk[:, 1:]] = 0
    over = d > 255
    n_over = over.sum(axis=1)
    K = int(n_over.max())
    if (d >= 0).all() and K <= S // 8:
        Kp = 8
        while Kp < K:
            Kp *= 2
        fix_pos = np.zeros((idx.shape[0], Kp), dtype=np.int32)
        fix_val = np.zeros((idx.shape[0], Kp), dtype=np.int32)
        if K:
            rows, cols = np.nonzero(over)
            slot = np.concatenate(
                [np.arange(n) for n in n_over]).astype(np.int64)
            fix_pos[rows, slot] = cols.astype(np.int32)
            fix_val[rows, slot] = (d[rows, cols] - 255).astype(np.int32)
        d8 = np.minimum(d, 255).astype(np.uint8)
        base = idx[:, 0].astype(np.int32)
        return _to_wire(codes, (d8, base, fix_pos, fix_val))
    if n_snps <= 0xFFFF and S % 2 == 0:
        u = idx.astype(np.uint32)
        pairs = (u[:, 0::2] | (u[:, 1::2] << 16)).view(np.int32)
        return Block((codes, pairs), ("u16", S))
    return Block((codes, idx), ("i32", S))


class BlockPacker:
    """An engine's block format and packing. cap_bq: the engine's (at
    most 126: the u8 codes); cell_block: the cells a block pads to;
    n_snps: the SNPs of the engine's tables (u16 id pairs need at most
    0xFFFF). The shape registry keeps same-shape v2 blocks on one layout
    across the engine's runs, and starts anew with each new wire config."""

    def __init__(self, cap_bq: int, cell_block: int, n_snps: int):
        self.cap_bq = cap_bq
        self.cell_block = cell_block
        self.n_snps = n_snps
        self.cfg = None  # the last wire config chosen: the registry's
        self._reg = {}
        self._lock = threading.Lock()

    def choose(self, scl, acct=None):
        """The run's format for a CSR pileup: its wire-v2 config, or None
        for the v1 forms (``SLOT_LIMIT``). Cached on the pileup. A run's
        set-up passes its ``phase_s`` as acct: setup.nsnp is the pass over
        all observations a new pileup takes (``CsrPileup.obs_pass``,
        native, which fills the caches of ``n_snps_all`` and of the code
        histogram; else ``n_snps_all``'s numpy pass), setup.wire_cfg
        ``choose_cfg`` (its numpy code pass where the native one did not
        run, and its sample of the first cells); a cached config takes
        neither."""
        # the cfg cache rides ON the pileup (an id(scl)-keyed cache could
        # serve a stale dictionary to a different pileup allocated at a
        # reused address)
        cache = getattr(scl, "_wire_cfg_cache", None)
        if cache is not None and cache[0] == self.cap_bq:
            cfg = cache[1]
        else:
            with span("setup.nsnp", acct):
                if hasattr(scl, "obs_pass"):
                    scl.obs_pass(self.cap_bq)
                smax = int(np.max(scl.n_snps_all(), initial=0))
            # conservative pow2 bucket: coverage-sorted blocking pads slot
            # axes to powers of two. If ANY block could pad past the limit,
            # the whole RUN takes the v1 forms; such a pileup is never
            # cached
            if _bucket(max(smax, 1), minimum=128) > SLOT_LIMIT:
                return None
            with span("setup.wire_cfg", acct):
                cfg = W.choose_cfg(scl, self.cap_bq)
            scl._wire_cfg_cache = (self.cap_bq, cfg)
        if cfg != self.cfg:
            self.cfg = cfg
            self._reg = {}
        return cfg

    def pack(self, scl, cells, cfg, pad=None) -> Block:
        """One block of a CSR pileup's cells in the run's format cfg
        (``choose``), padded to the cell block and to pad slots (None: a
        multiple of 128): the native packer's single pass, else
        ``build_codes_block`` and the numpy packing."""
        kw = {} if pad is None else {"pad_slots_to": pad}
        if nprep.available():
            if cfg is not None:
                out = self._pack_reg(lambda ff: npack.pack_block_v2(
                    scl, cells, cfg, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, floors_for=ff, **kw,
                ))
                if out is not None:
                    return out
            else:
                blk = nprep.prep_block_shrunk(
                    scl, cells, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, **kw,
                )
                if blk is not None:
                    return _to_wire(*blk[:2])
        codes_blk = build_codes_block(
            scl, cells, cap_bq=self.cap_bq,
            pad_cells_to=self.cell_block, **kw,
        )
        if cfg is None:
            return _shrink_codes_blk(codes_blk, self.n_snps)
        key = (codes_blk[0].shape[1], codes_blk[0].shape[2])
        out = self._pack_reg(
            lambda ff: W.pack_wire_block(*codes_blk, cfg, floors=ff(key)))
        if out is None:
            # a v1-form block would be scored against the dict-narrowed
            # tables of the v2 run: choose's slot limit makes this
            # unreachable; fail loudly if it ever is not
            raise RuntimeError("v1-form block in a wire-v2 run")
        return out

    def _pack_reg(self, pack_fn):
        """Pack a v2 block through the shape registry: pack_fn receives a
        floors-lookup callable (key=(S, U) -> harmonized (U0, K2p, Kp) or
        None); afterwards the produced meta raises its key's maxima.
        Prefetch threads race benignly — a stale floor only costs one
        extra layout, never correctness."""

        def floors_for(key):
            with self._lock:
                return self._reg.get(key)

        out = pack_fn(floors_for)
        if out is None:
            return None
        buf, meta = out
        key = (meta[1], meta[2])
        u0, k2p, kp = meta[3], meta[4], meta[5]
        with self._lock:
            cur = self._reg.get(key)
            if cur is None:
                self._reg[key] = (u0, k2p, kp)
            else:
                self._reg[key] = (
                    cur[0], max(cur[1], k2p), max(cur[2], kp))
        return Block((buf,), meta)
