"""rANS 4x8 codec (CRAM 3.0 block compression method 4), from scratch.

Four interleaved byte-wise range-ANS states, 12-bit normalized frequencies,
order-0 and order-1 models — the scheme htslib calls "rans_static 4x8".
Layout of a compressed stream:

  byte  0      : order (0 or 1)
  bytes 1-4    : compressed size of everything after this header (LE)
  bytes 5-8    : uncompressed size (LE)
  then         : frequency table(s), then the interleaved rANS byte stream

Frequency tables use the ascending-symbol RLE scheme: a symbol byte, its
frequency (7-bit, or 15-bit when the first byte has the top bit set), and a
run-length byte whenever the next symbol is consecutive; a 0x00 symbol
terminates. Order-1 nests one order-0-style table per context symbol.

The encoder exists mainly to test the decoder and to exercise CRAM fixtures
through the rANS path; both are self-consistent implementations of the
published scheme.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from demuxlet_tpu_torch.utils.logging_utils import error

TOTFREQ = 1 << 12  # 12-bit normalization
RANS_L = 1 << 23  # lower bound of the state interval


# ---------------------------------------------------------------- helpers
def _normalize(freqs: List[int], total_target: int = TOTFREQ) -> List[int]:
    """Scale raw counts to sum to total_target, keeping nonzero counts >= 1."""
    total = sum(freqs)
    if total == 0:
        return freqs
    out = [0] * len(freqs)
    # largest remainder method with nonzero floor
    scaled = [(f * total_target) / total if f else 0.0 for f in freqs]
    for i, s in enumerate(scaled):
        out[i] = max(1, int(s)) if freqs[i] else 0
    diff = total_target - sum(out)
    # fix up rounding drift on the most frequent symbols
    order = sorted(range(len(freqs)), key=lambda i: -freqs[i])
    k = 0
    while diff != 0:
        i = order[k % len(order)]
        if freqs[i]:
            step = 1 if diff > 0 else -1
            if out[i] + step >= 1:
                out[i] += step
                diff -= step
        k += 1
    return out


def _write_freq(f: int) -> bytes:
    if f < 128:
        return bytes([f])
    return bytes([0x80 | (f >> 8), f & 0xFF])


class _Rd:
    __slots__ = ("d", "o")

    def __init__(self, d: bytes, o: int = 0):
        self.d = d
        self.o = o

    def u8(self) -> int:
        v = self.d[self.o]
        self.o += 1
        return v

    def freq(self) -> int:
        f = self.u8()
        if f >= 128:
            f = ((f & 0x7F) << 8) | self.u8()
        return f


def _write_alphabet(freqs: List[int], emit_freq) -> bytes:
    """Ascending-symbol RLE walk shared by order-0 and order-1 tables.

    Stream grammar (mirrors the reader): sym f [next_sym run f f ...] ... 0
    — when the following symbol is consecutive, it appears explicitly once,
    then a run byte counts FURTHER consecutive symbols whose freqs follow
    without symbol bytes."""
    syms = [i for i, f in enumerate(freqs) if f]
    out = bytearray()
    i = 0
    while i < len(syms):
        out.append(syms[i])
        out += emit_freq(syms[i])
        run = 0
        while i + run + 1 < len(syms) and syms[i + run + 1] == syms[i + run] + 1:
            run += 1
        if run > 0:
            out.append(syms[i + 1])
            out.append(run - 1)
            for r in range(1, run + 1):
                out += emit_freq(syms[i + r])
        i += run + 1
    out.append(0)  # terminator
    return bytes(out)


def _read_alphabet(rd: _Rd, read_freq) -> List[int]:
    """Returns the symbol list in table order; read_freq(sym) consumes the
    frequency payload for each symbol."""
    syms = []
    sym = rd.u8()
    rle = 0
    while True:
        syms.append(sym)
        read_freq(sym)
        if rle > 0:
            rle -= 1
            sym += 1
        else:
            nxt = rd.u8()
            if nxt == 0:
                break
            if nxt == sym + 1:
                rle = rd.u8()
                sym = nxt
            else:
                sym = nxt
    return syms


# ---------------------------------------------------------------- order 0
def _build_tables(freqs: List[int]):
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    sym_of = [0] * TOTFREQ
    for s in range(256):
        for x in range(cum[s], cum[s + 1]):
            sym_of[x] = s
    return cum, sym_of


def compress_o0(data: bytes) -> bytes:
    raw = [0] * 256
    for b in data:
        raw[b] += 1
    freqs = _normalize(raw)
    cum, _ = _build_tables(freqs)
    table = _write_alphabet(freqs, lambda s: _write_freq(freqs[s]))

    states = [RANS_L] * 4
    out = bytearray()
    # encode in reverse; decoder reads forward, state j owns positions i%4==j
    for i in range(len(data) - 1, -1, -1):
        j = i & 3
        s = data[i]
        f = freqs[s]
        x = states[j]
        x_max = ((RANS_L >> 12) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << 12) + (x % f) + cum[s]
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", states[j])
    payload = table + bytes(head) + bytes(reversed(out))
    return bytes([0]) + struct.pack("<II", len(payload), len(data)) + payload


def _decompress_o0(rd: _Rd, out_sz: int) -> bytes:
    freqs = [0] * 256
    _read_alphabet(rd, lambda s: freqs.__setitem__(s, rd.freq()))
    cum, sym_of = _build_tables(freqs)
    states = [struct.unpack_from("<I", rd.d, rd.o + 4 * j)[0] for j in range(4)]
    rd.o += 16
    out = bytearray(out_sz)
    o = rd.o
    d = rd.d
    n = len(d)
    for i in range(out_sz):
        j = i & 3
        x = states[j]
        slot = x & (TOTFREQ - 1)
        s = sym_of[slot]
        out[i] = s
        x = freqs[s] * (x >> 12) + slot - cum[s]
        while x < RANS_L and o < n:
            x = (x << 8) | d[o]
            o += 1
        states[j] = x
    rd.o = o
    return bytes(out)


# ---------------------------------------------------------------- order 1
def compress_o1(data: bytes) -> bytes:
    if len(data) < 4:
        return compress_o0(data)  # order-1 needs 4 quarters
    isz4 = len(data) >> 2
    # context chains: state j encodes data[j*isz4 : (j+1)*isz4); the
    # remainder tail is encoded by state 3
    raw = [[0] * 256 for _ in range(256)]
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    ends = [isz4, 2 * isz4, 3 * isz4, len(data)]
    for j in range(4):
        ctx = 0
        for i in range(starts[j], ends[j]):
            raw[ctx][data[i]] += 1
            ctx = data[i]
    freqs = [(_normalize(row) if sum(row) else row) for row in raw]
    tabs = {}
    for c in range(256):
        if sum(freqs[c]):
            tabs[c] = _build_tables(freqs[c])

    # table serialization: context alphabet walk, nested order-0 tables
    ctx_freq_presence = [1 if sum(freqs[c]) else 0 for c in range(256)]

    def emit_ctx(c: int) -> bytes:
        return _write_alphabet(freqs[c], lambda s: _write_freq(freqs[c][s]))

    table = _write_alphabet(ctx_freq_presence, emit_ctx)

    # Encode along the exact reverse of the decoder's interleaved schedule
    # (round-robin over active streams) so the shared byte stream unwinds
    # in the right order.
    sched: List[Tuple[int, int]] = []
    ptrs = list(starts)
    remaining = [ends[j] - starts[j] for j in range(4)]
    while any(remaining):
        for j in range(4):
            if remaining[j]:
                sched.append((j, ptrs[j]))
                ptrs[j] += 1
                remaining[j] -= 1

    states = [RANS_L] * 4
    out = bytearray()
    for j, pos in reversed(sched):
        ctx = data[pos - 1] if pos > starts[j] else 0
        s = data[pos]
        cum, _ = tabs[ctx]
        f = freqs[ctx][s]
        x = states[j]
        x_max = ((RANS_L >> 12) << 8) * f
        while x >= x_max:
            out.append(x & 0xFF)
            x >>= 8
        states[j] = ((x // f) << 12) + (x % f) + cum[s]
    head = bytearray()
    for j in range(4):
        head += struct.pack("<I", states[j])
    payload = table + bytes(head) + bytes(reversed(out))
    return bytes([1]) + struct.pack("<II", len(payload), len(data)) + payload


def _decompress_o1(rd: _Rd, out_sz: int) -> bytes:
    freqs = {}

    def read_ctx(c: int):
        row = [0] * 256
        _read_alphabet(rd, lambda s: row.__setitem__(s, rd.freq()))
        freqs[c] = row

    _read_alphabet(rd, read_ctx)
    tabs = {c: _build_tables(row) for c, row in freqs.items()}
    states = [struct.unpack_from("<I", rd.d, rd.o + 4 * j)[0] for j in range(4)]
    rd.o += 16
    isz4 = out_sz >> 2
    starts = [0, isz4, 2 * isz4, 3 * isz4]
    ends = [isz4, 2 * isz4, 3 * isz4, out_sz]
    out = bytearray(out_sz)
    ctxs = [0, 0, 0, 0]
    ptrs = list(starts)
    o = rd.o
    d = rd.d
    n = len(d)
    # interleaved: one byte per state round-robin while any stream active
    remaining = [ends[j] - starts[j] for j in range(4)]
    while any(remaining):
        for j in range(4):
            if not remaining[j]:
                continue
            x = states[j]
            slot = x & (TOTFREQ - 1)
            cum, sym_of = tabs[ctxs[j]]
            s = sym_of[slot]
            out[ptrs[j]] = s
            row = freqs[ctxs[j]]
            x = row[s] * (x >> 12) + slot - cum[s]
            while x < RANS_L and o < n:
                x = (x << 8) | d[o]
                o += 1
            states[j] = x
            ctxs[j] = s
            ptrs[j] += 1
            remaining[j] -= 1
    rd.o = o
    return bytes(out)


# ---------------------------------------------------------------- api
def compress(data: bytes, order: int = 0) -> bytes:
    if len(data) == 0:
        return bytes([order]) + struct.pack("<II", 0, 0)
    return compress_o1(data) if order == 1 else compress_o0(data)


def decompress(blob: bytes) -> bytes:
    if len(blob) < 9:
        error("rANS: truncated stream")
    order = blob[0]
    _csize, rsize = struct.unpack_from("<II", blob, 1)
    if rsize == 0:
        return b""
    rd = _Rd(blob, 9)
    try:
        if order == 0:
            return _decompress_o0(rd, rsize)
        if order == 1:
            return _decompress_o1(rd, rsize)
    except (IndexError, struct.error):
        # truncated/corrupt payload: surface the clean parser error path
        # instead of a bare IndexError from _Rd.u8 mid-decode
        error("rANS: truncated stream")
    error("rANS: unknown order %d", order)
