"""BGZF block gzip: reader helpers and a writer.

BGZF (the SAM spec's blocked-gzip variant) is a series of concatenated gzip
members, each <= 64 KiB uncompressed, carrying a BC extra subfield with the
compressed block size. Python's gzip module transparently reads concatenated
members, so sequential reads just use gzip. The writer here produces
spec-compliant BGZF (used by test fixtures and the output writers when a
.gz suffix is requested), including the 28-byte EOF sentinel block.
"""

from __future__ import annotations

import struct
import zlib
from typing import IO

# The BGZF EOF marker block (SAM spec section 4.1.2)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_MAX_BLOCK = 65280  # uncompressed payload limit per block


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One BGZF block for <= 64 KiB of data."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    bsize = len(comp) + 25 + 1  # header(12) + XLEN payload(6) + crc/isize(8)
    header = struct.pack(
        "<4BIBBHBBHH",
        0x1F,
        0x8B,
        0x08,
        0x04,  # magic + FLG.FEXTRA
        0,  # MTIME
        0,  # XFL
        0xFF,  # OS
        6,  # XLEN
        0x42,  # 'B'
        0x43,  # 'C'
        2,  # SLEN
        bsize - 1,  # BSIZE-1
    )
    return header + comp + struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))


def read_block_at(fh: IO[bytes]):
    """Read + decompress ONE BGZF member at the current file offset.

    Returns the uncompressed bytes, or None at EOF / on a non-BGZF
    header (callers treat that as end of data)."""
    hdr = fh.read(12)
    if len(hdr) < 12 or hdr[0] != 0x1F or hdr[1] != 0x8B:
        return None
    xlen = struct.unpack("<H", hdr[10:12])[0]
    extra = fh.read(xlen)
    bsize = 0
    off = 0
    while off + 4 <= len(extra):
        si1, si2 = extra[off], extra[off + 1]
        slen = struct.unpack("<H", extra[off + 2 : off + 4])[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack("<H", extra[off + 4 : off + 6])[0] + 1
        off += 4 + slen
    if bsize < 12 + xlen + 8 + 2:  # corrupt BSIZE: refuse, don't slurp
        return None
    payload = fh.read(bsize - 12 - xlen - 8)
    fh.read(8)  # CRC + ISIZE
    try:
        return zlib.decompress(payload, -15)
    except zlib.error:
        return None


def iter_lines_from(path: str, voff: int):
    """Yield text lines from a BGZF file starting at virtual offset
    voff = (compressed_offset << 16) | uncompressed_offset — the tabix /
    BAI seek primitive. Stops at EOF."""
    with open(path, "rb") as fh:
        fh.seek(voff >> 16)
        carry = b""
        first = True
        while True:
            block = read_block_at(fh)
            if block is None:
                if carry:
                    yield carry.decode("utf-8", "replace")
                return
            if first:
                block = block[voff & 0xFFFF :]
                first = False
            data = carry + block
            lines = data.split(b"\n")
            carry = lines.pop()
            for ln in lines:
                yield ln.decode("utf-8", "replace")


class BgzfByteStream:
    """Minimal binary read(n) view over a BGZF file starting at a virtual
    offset — the seek primitive for indexed binary formats (BCF + .csi).
    read() returns fewer than n bytes only at EOF."""

    def __init__(self, path: str, voff: int):
        self._fh = open(path, "rb")
        self._fh.seek(voff >> 16)
        self._buf = b""
        self._first_skip = voff & 0xFFFF

    def read(self, n: int) -> bytes:
        while len(self._buf) < n:
            block = read_block_at(self._fh)
            if block is None:
                break
            if self._first_skip:
                block = block[self._first_skip :]
                self._first_skip = 0
            self._buf += block
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        self._fh.close()


class BgzfWriter:
    def __init__(self, fh: IO[bytes], level: int = 6):
        self._fh = fh
        self._buf = bytearray()
        self._level = level

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= _MAX_BLOCK:
            chunk = bytes(self._buf[:_MAX_BLOCK])
            del self._buf[:_MAX_BLOCK]
            self._fh.write(compress_block(chunk, self._level))

    def close(self) -> None:
        if self._buf:
            self._fh.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.write(BGZF_EOF)
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
