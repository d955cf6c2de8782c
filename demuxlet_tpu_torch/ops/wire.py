"""Device decode of the blocks the engine ships (port of
``demuxlet_tpu/ops/pallas_pair.py`` ``_unpack_bits_dev`` :872,
``_unpack_wire_v2`` :890 and ``unpack_block_inputs`` :987).

``decode`` reads each form ``models/blocks.py`` packs, named by the
block's meta: the wire v2 ("w2"), the fused v1 wire ("v1"), and u8 codes
beside 16-bit id pairs ("u16") or plain int32 ids ("i32"). Bitcasts are
little-endian views: u8 via ``view(torch.uint8)``, u16 via
``view(torch.int16)`` then ``& 0xFFFF`` in int32 (``torch.uint16`` has no
shift operators). Out-of-bounds scatters, which JAX drops with
``mode="drop"``, are redirected to a trash column that is cut off after
the scatter, so no index ever leaves its tensor. Slot ids come back as
int64 (``torch.cumsum`` of int32 returns int64); their values equal the
JAX package's int32 ids.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

rebuilds = 0  # rebuild_lanes calls since import (the exact engine makes none)


class Parts(NamedTuple):
    """A decoded block, as the fronts read it."""

    dense: torch.Tensor  # (B, S, U0) int32 codes, the none code in empty lanes
    tail: Optional[tuple]  # the v2 deep-lane tail (tpos, tcode), or None
    n_deep: int  # the lanes past U0 that the tail addresses (U - U0)
    idx: torch.Tensor  # (B, S) int64 SNP ids
    msk: torch.Tensor  # (B, S) bool: the slot covers a SNP


def _u8(words: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 words -> (B, 4n) int32 of their little-endian bytes."""
    return words.contiguous().view(torch.uint8).to(torch.int32)


def _u16(words: torch.Tensor) -> torch.Tensor:
    """(B, n) int32 words -> (B, 2n) int32 of their little-endian u16s."""
    return words.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF


def unpack_bits(by: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """(B, n*width/8) byte values (int32) -> (B, n) int32; width in
    {4, 6, 8}. Inverse of ``demuxlet_tpu.host.wire.pack_bits``."""
    B = by.shape[0]
    if width == 8:
        return by[:, :n]
    if width == 4:
        return torch.stack([by & 15, by >> 4], dim=-1).reshape(B, -1)[:, :n]
    b = by.reshape(B, -1, 3)
    q0 = b[..., 0] & 63
    q1 = ((b[..., 0] >> 6) | (b[..., 1] << 2)) & 63
    q2 = ((b[..., 1] >> 4) | (b[..., 2] << 4)) & 63
    q3 = b[..., 2] >> 2
    return torch.stack([q0, q1, q2, q3], dim=-1).reshape(B, -1)[:, :n]


def _apply_fixes(d, base, fix_pos, fix_val):
    """idx = base + cumsum(d + escapes). Dummy fixes are (pos 0, val 0) and
    duplicates accumulate, as JAX's ``.at[].add`` does."""
    d = d.to(torch.int64).scatter_add(1, fix_pos.to(torch.int64),
                                      fix_val.to(torch.int64))
    return base.to(torch.int64)[:, None] + torch.cumsum(d, dim=1)


def _unpack_v2(wbuf: torch.Tensor, meta) -> Parts:
    """The v2 packed wire (``host/wire.pack_wire_block``) as its parts:
    the dense lanes in wire-code space [0, n_real+1] and the deep-lane
    tail, not rebuilt into lanes (``rebuild_lanes`` does that); msk
    derives from the dense lanes alone (the packer puts the marker in
    lane 0 of a tail-only slot)."""
    _, S, U, U0, K2p, Kp, cw, dw, n_real, tw = meta
    B = wbuf.shape[0]
    none = n_real + 1
    ncb = S * U0 * cw // 8 // 4
    dense = unpack_bits(_u8(wbuf[:, :ncb]), cw, S * U0).reshape(B, S, U0)
    off = ncb
    tail_parts = None
    if K2p:
        if tw == 16:
            ntp = K2p * 2 // 4
            tpos = _u16(wbuf[:, off : off + ntp])
        elif tw == 24:
            # (slot u16, lane u8) planes; pad slot == S rebuilds to the
            # S*(U-U0) out-of-bounds sentinel, as for tw == 32
            ns = K2p * 2 // 4
            nl = K2p // 4
            tslot = _u16(wbuf[:, off : off + ns])
            tlane = _u8(wbuf[:, off + ns : off + ns + nl])
            tpos = tslot * (U - U0) + tlane
            ntp = ns + nl
        else:
            ntp = K2p
            tpos = wbuf[:, off : off + ntp]
        off += ntp
        ntc = K2p * cw // 8 // 4
        tcode = unpack_bits(_u8(wbuf[:, off : off + ntc]), cw, K2p)
        off += ntc
        tail_parts = (tpos, tcode)
    if dw == 16:
        ndb = S // 2
        d = _u16(wbuf[:, off : off + ndb])
    else:
        ndb = S * dw // 8 // 4
        d = unpack_bits(_u8(wbuf[:, off : off + ndb]), dw, S)
    off += ndb
    base = wbuf[:, off]
    fix_pos = _u16(wbuf[:, off + 1 : off + 1 + Kp // 2])
    fix_val = wbuf[:, off + 1 + Kp // 2 : off + 1 + Kp // 2 + Kp]
    idx = _apply_fixes(d, base, fix_pos, fix_val)
    msk = (dense != none).any(dim=-1)
    return Parts(dense, tail_parts, U - U0, idx, msk)


def rebuild_lanes(dense, tpos, tcode, n_deep, fill):
    """The full lanes (B, S, U0 + n_deep) int32 of a v2 wire's parts:
    dense (B, S, U0), the tail's flat positions tpos (slot * n_deep + the
    lane past U0) and codes tcode, (B, K2p); the deep lanes without an entry
    hold ``fill``. Counted in ``rebuilds``."""
    global rebuilds
    rebuilds += 1
    B, S, _ = dense.shape
    n = S * n_deep
    # pad entries point at or past n: send them to the trash column
    tpos = torch.where(tpos < n, tpos, n).to(torch.int64)
    tail = torch.full((B, n + 1), fill, dtype=torch.int32,
                      device=dense.device)
    tail.scatter_(1, tpos, tcode.to(torch.int32))
    return torch.cat([dense.to(torch.int32),
                      tail[:, :n].reshape(B, S, n_deep)], dim=2)


def decode(bufs, meta) -> Parts:
    """A shipped block, its buffers (``models/blocks.Block.bufs``) on the
    device and its meta, as ``Parts``. The v1 forms carry u8 codes, 255
    for none and 254 in lane 0 of a covered slot without codes; their
    mask derives from the codes, and all their lanes are dense."""
    form, S = meta[0], meta[1]
    if form == "w2":
        return _unpack_v2(bufs[0], meta)
    if form == "v1":
        U, K = meta[2:]
        (wbuf,) = bufs
        B = wbuf.shape[0]
        nc, nd = S * U // 4, S // 4
        codes = wbuf[:, :nc].contiguous().view(torch.uint8).reshape(B, S, U)
        d8 = wbuf[:, nc : nc + nd].contiguous().view(torch.uint8)
        base = wbuf[:, nc + nd]
        fix_pos = wbuf[:, nc + nd + 1 : nc + nd + 1 + K]
        fix_val = wbuf[:, nc + nd + 1 + K : nc + nd + 1 + 2 * K]
        idx = _apply_fixes(d8, base, fix_pos, fix_val)
    else:
        codes, ids = bufs
        if form == "u16":
            ids = torch.stack([ids & 0xFFFF, (ids >> 16) & 0xFFFF], dim=-1)
        idx = ids.reshape(codes.shape[0], S).to(torch.int64)
    msk = (codes != 255).any(dim=-1)
    return Parts(codes.to(torch.int32), None, 0, idx, msk)
