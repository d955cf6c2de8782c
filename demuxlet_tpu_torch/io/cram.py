"""CRAM 3.0 reading (subset, from scratch — no htslib).

Reference analog: the CRAM half of SAMFilteredReader (via htslib cram_*).
This decoder covers the containers/blocks/slice structure, ITF8/LTF8
varints, raw/gzip/bzip2/lzma/rANS-4x8 block compression (io/rans.py),
the EXTERNAL / BYTE_ARRAY_STOP / BYTE_ARRAY_LEN encodings, and the
core-bitstream codecs (multi-symbol canonical HUFFMAN, BETA, GAMMA,
SUBEXP) over the slice's shared CORE data block. Multi-slice containers
are handled (slices iterate until the container body is consumed).

Key demuxlet-specific design point: CRAM stores reads as features (diffs)
against the reference genome, and the FASTA is not a demuxlet input. But the
pileup only ever needs the read base AT SNP POSITIONS, where the reference
base IS the VCF REF allele. CramRead therefore implements base_qual_at()
directly over the feature list: a substitution ('X') landing on the SNP
resolves through the header's substitution matrix using the VCF REF base;
a match region yields the REF base itself. This makes CRAM demultiplexing
work without any FASTA, which htslib cannot do.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

from demuxlet_tpu_torch.utils.logging_utils import error

READ_INDEX_NA = -1

# block compression methods
RAW, GZIP, BZIP2, LZMA, RANS = 0, 1, 2, 3, 4
# block content types
FILE_HEADER, COMPRESSION_HEADER, SLICE_HEADER, EXTERNAL, CORE = 0, 1, 2, 4, 5

BASES = "ACGTN"


class _Buf:
    __slots__ = ("d", "o")

    def __init__(self, d: bytes, o: int = 0):
        self.d = d
        self.o = o

    def u8(self) -> int:
        v = self.d[self.o]
        self.o += 1
        return v

    def bytes(self, n: int) -> bytes:
        b = self.d[self.o : self.o + n]
        self.o += n
        return b

    def i32(self) -> int:
        (v,) = struct.unpack_from("<i", self.d, self.o)
        self.o += 4
        return v

    def itf8(self) -> int:
        b0 = self.u8()
        if b0 < 0x80:
            return b0
        if b0 < 0xC0:
            return ((b0 & 0x3F) << 8) | self.u8()
        if b0 < 0xE0:
            return ((b0 & 0x1F) << 16) | (self.u8() << 8) | self.u8()
        if b0 < 0xF0:
            v = (b0 & 0x0F) << 24
            v |= (self.u8() << 16) | (self.u8() << 8) | self.u8()
            return v
        v = (b0 & 0x0F) << 28
        v |= (self.u8() << 20) | (self.u8() << 12) | (self.u8() << 4)
        v |= self.u8() & 0x0F
        return v - (1 << 32) if v >= (1 << 31) else v

    def itf8_signed(self) -> int:
        v = self.itf8()
        return v - (1 << 32) if v >= (1 << 31) else v

    def ltf8(self) -> int:
        b0 = self.u8()
        n = 0
        while n < 8 and (b0 << n) & 0x80:
            n += 1
        v = b0 & (0xFF >> n) if n < 8 else 0
        for _ in range(n):
            v = (v << 8) | self.u8()
        return v


def _sign32(v: int) -> int:
    return v - (1 << 32) if v >= (1 << 31) else v


class _Bits:
    """MSB-first bit reader over the slice's CORE data block. All
    core-encoded data series of a slice share ONE cursor, interleaved in
    record order (CRAM 3.0 section 8)."""

    __slots__ = ("d", "byte", "bit")

    def __init__(self, d: bytes):
        self.d = d
        self.byte = 0
        self.bit = 7

    def read_bit(self) -> int:
        if self.byte >= len(self.d):
            error("CRAM: core bitstream exhausted")
        v = (self.d[self.byte] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.byte += 1
        else:
            self.bit -= 1
        return v

    def read_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.read_bit()
        return v


class _Huffman:
    """Canonical Huffman decoder (CRAM 3.0 section 13.4): alphabet sorted
    by (bit length, symbol value), codes assigned in ascending order."""

    __slots__ = ("by_len",)

    def __init__(self, symbols, lengths):
        pairs = sorted(zip(lengths, symbols))
        self.by_len: Dict[int, Dict[int, int]] = {}
        code = 0
        prev_len = pairs[0][0]
        for ln, sym in pairs:
            code <<= ln - prev_len
            prev_len = ln
            self.by_len.setdefault(ln, {})[code] = sym
            code += 1

    def decode(self, bits: _Bits) -> int:
        code = 0
        ln = 0
        for _ in range(32):
            code = (code << 1) | bits.read_bit()
            ln += 1
            tab = self.by_len.get(ln)
            if tab is not None and code in tab:
                return tab[code]
        error("CRAM: invalid huffman code in core stream")


@dataclass
class Encoding:
    codec: int  # 0 NULL, 1 EXTERNAL, 3 HUFFMAN, 4 BYTE_ARRAY_LEN, 5 BYTE_ARRAY_STOP
    params: bytes

    def parse(self):
        b = _Buf(self.params)
        if self.codec == 1:  # EXTERNAL: content id
            return ("external", b.itf8())
        if self.codec == 3:  # HUFFMAN: alphabet + lengths
            n = b.itf8()
            symbols = [b.itf8_signed() for _ in range(n)]
            n2 = b.itf8()
            lengths = [b.itf8() for _ in range(n2)]
            return ("huffman", symbols, lengths)
        if self.codec == 4:  # BYTE_ARRAY_LEN: len encoding + val encoding
            lc = b.itf8()
            lp = b.bytes(b.itf8())
            vc = b.itf8()
            vp = b.bytes(b.itf8())
            return ("byte_array_len", Encoding(lc, lp), Encoding(vc, vp))
        if self.codec == 5:  # BYTE_ARRAY_STOP: stop byte + content id
            stop = b.u8()
            return ("byte_array_stop", stop, b.itf8())
        if self.codec == 6:  # BETA: offset + bit length (core bitstream)
            return ("beta", b.itf8_signed(), b.itf8())
        if self.codec == 7:  # SUBEXP: offset + k (core bitstream)
            return ("subexp", b.itf8_signed(), b.itf8())
        if self.codec == 9:  # GAMMA: offset (core bitstream)
            return ("gamma", b.itf8_signed())
        if self.codec == 0:
            return ("null",)
        error("CRAM: unsupported encoding codec %d", self.codec)


class _Series:
    """A decodable data series bound to its external stream(s) and/or the
    slice's shared core bitstream."""

    def __init__(self, enc: Encoding, streams: Dict[int, _Buf],
                 core: Optional["_Bits"] = None):
        self.kind = enc.parse()
        self.streams = streams
        self.core = core
        if self.kind[0] == "huffman" and not all(
            l == 0 for l in self.kind[2]
        ):
            self._huff = _Huffman(self.kind[1], self.kind[2])
        else:
            self._huff = None

    def _bits(self) -> "_Bits":
        if self.core is None:
            error("CRAM: core-encoded series but no core data block")
        return self.core

    def _stream(self, cid: int) -> _Buf:
        s = self.streams.get(cid)
        if s is None:
            error("CRAM: missing external block id %d", cid)
        return s

    def read_int(self) -> int:
        k = self.kind
        if k[0] == "external":
            return self._stream(k[1]).itf8_signed()
        if k[0] == "huffman":
            if self._huff is None:
                return k[1][0]  # zero-bit: constant symbol
            return self._huff.decode(self._bits())
        if k[0] == "beta":
            offset, nbits = k[1], k[2]
            return self._bits().read_bits(nbits) - offset
        if k[0] == "gamma":
            # Elias gamma: N leading zeros, then the N+1-bit value
            bits = self._bits()
            n = 0
            while bits.read_bit() == 0:
                n += 1
            v = 1
            for _ in range(n):
                v = (v << 1) | bits.read_bit()
            return v - 1 - k[1]
        if k[0] == "subexp":
            offset, kk = k[1], k[2]
            bits = self._bits()
            u = 0
            while bits.read_bit() == 1:
                u += 1
            if u == 0:
                v = bits.read_bits(kk)
            else:
                b = u + kk - 1
                v = bits.read_bits(b) + (1 << b)
            return v - offset
        error("CRAM: encoding %s cannot produce ints", k[0])

    def read_byte(self) -> int:
        k = self.kind
        if k[0] in ("huffman", "beta", "gamma", "subexp"):
            return self.read_int()
        if k[0] == "external":
            return self._stream(k[1]).u8()
        error("CRAM: encoding %s cannot produce bytes", k[0])

    def read_bytes(self, n: int) -> bytes:
        k = self.kind
        if k[0] == "external":
            return self._stream(k[1]).bytes(n)
        error("CRAM: encoding %s cannot produce byte runs", k[0])

    def read_array(self) -> bytes:
        k = self.kind
        if k[0] == "byte_array_stop":
            stop, cid = k[1], k[2]
            s = self._stream(cid)
            end = s.d.index(bytes([stop]), s.o)
            out = s.d[s.o : end]
            s.o = end + 1
            return out
        if k[0] == "byte_array_len":
            ln = _Series(k[1], self.streams, self.core).read_int()
            return _Series(k[2], self.streams, self.core).read_bytes(ln)
        error("CRAM: encoding %s cannot produce arrays", k[0])


@dataclass
class Feature:
    code: str
    pos: int  # 1-based position in the read
    data: object = None
    qv: Optional[bytes] = None  # per-base quals carried by the feature
    # ('B' base+qual): used only when the read's quals are not preserved
    # wholesale — preserved QS arrays overwrite feature quals, matching
    # htslib's decode order (cram_decode.c applies feature quals first,
    # then the CF_PRESERVE_QS array over the top)


@dataclass
class CramRead:
    """Duck-type of io.bam.AlignedRead over CRAM features (no FASTA)."""

    tid: int
    pos: int  # 0-based
    mapq: int
    flag: int
    l_qseq: int
    features: List[Feature]
    quals: bytes
    tags: dict
    bases: Optional[bytes] = None  # unmapped reads store bases directly

    def endpos(self) -> int:
        rlen = self.l_qseq
        for f in self.features:
            if f.code in ("D", "N"):
                rlen += f.data
            elif f.code == "I":
                rlen -= len(f.data)
            elif f.code == "S":
                rlen -= len(f.data)
            elif f.code == "i":
                rlen -= 1
        return self.pos + (rlen if rlen > 0 else 1)

    @property
    def qual(self) -> bytes:
        return self.quals

    def base_qual_at(self, gpos: int, ref_base: str = "N") -> Tuple[str, int, int]:
        """Base/qual at genomic position; matches resolve to ref_base (the
        VCF REF allele at SNP positions — see module docstring).

        Returns (base, phred_qual, read_pos) with read_pos == -1 when the
        position falls in a deletion/skip/outside the read."""
        # walk features in read order, maintaining (ref_pos, read_pos)
        cpos = self.pos  # genomic 0-based of next unconsumed ref base
        rpos = 0  # 0-based read offset of next unconsumed base
        subst: Optional[int] = None
        for f in self.features:
            fread = f.pos - 1  # 0-based read offset of the feature
            gap = fread - rpos  # match run before this feature
            if f.code in ("D", "N"):
                gap = fread - rpos  # deletion sits between read bases
                if cpos <= gpos < cpos + gap:
                    rpos += gpos - cpos
                    return self._resolve(gpos, rpos, ref_base, None)
                cpos += gap
                rpos += gap
                if cpos <= gpos < cpos + f.data:
                    return ("N", 0, READ_INDEX_NA)
                cpos += f.data
            elif f.code in ("S", "I"):
                if cpos <= gpos < cpos + gap:
                    rpos += gpos - cpos
                    return self._resolve(gpos, rpos, ref_base, None)
                cpos += gap
                rpos += gap
                rpos += len(f.data)
            elif f.code == "i":
                if cpos <= gpos < cpos + gap:
                    rpos += gpos - cpos
                    return self._resolve(gpos, rpos, ref_base, None)
                cpos += gap
                rpos += gap
                rpos += 1
            elif f.code == "X":
                if cpos <= gpos < cpos + gap:
                    rpos += gpos - cpos
                    return self._resolve(gpos, rpos, ref_base, None)
                cpos += gap
                rpos += gap
                if gpos == cpos:
                    return self._resolve(gpos, rpos, ref_base, f.data)
                cpos += 1
                rpos += 1
            elif f.code == "b":  # explicit base run (read+ref consumed)
                if cpos <= gpos < cpos + gap:
                    rpos += gpos - cpos
                    return self._resolve(gpos, rpos, ref_base, None)
                cpos += gap
                rpos += gap
                run = len(f.data)
                if cpos <= gpos < cpos + run:
                    off = gpos - cpos
                    if rpos + off < len(self.quals):
                        q = self.quals[rpos + off]  # preserved QS wins
                    elif f.qv is not None and off < len(f.qv):
                        q = f.qv[off]  # 'B' feature's stored qual
                    else:
                        q = 0
                    return (chr(f.data[off]), q, rpos + off)
                cpos += run
                rpos += run
            # H, P, Q, q: consume nothing
        if cpos <= gpos and rpos + (gpos - cpos) < self.l_qseq:
            rpos += gpos - cpos
            return self._resolve(gpos, rpos, ref_base, None)
        return ("N", 0, READ_INDEX_NA)

    def _resolve(self, gpos, rpos, ref_base, subst_code):
        if rpos < 0 or rpos >= self.l_qseq:
            return ("N", 0, READ_INDEX_NA)
        q = self.quals[rpos] if rpos < len(self.quals) else 0
        if subst_code is not None:
            base = self._matrix(ref_base, subst_code)
        elif self.bases is not None:
            base = chr(self.bases[rpos])
        else:
            base = ref_base
        return (base, q, rpos)

    def _matrix(self, ref_base: str, code):
        return code(ref_base)


class CramReader:
    """Sequential CRAM 3.0 reader with the AlignmentReader interface
    (refs/ref_lens, records(), filtered() with n_read/n_skip counters)."""

    def __init__(self, path: str, min_mq: int = 20, excl_flag: int = 0x0F04):
        self.path = path
        self.min_mq = min_mq
        self.excl_flag = excl_flag
        self.n_read = 0
        self.n_skip = 0
        with open(path, "rb") as fh:
            self._data = fh.read()
        b = _Buf(self._data)
        if b.bytes(4) != b"CRAM":
            error("%s is not a CRAM file (bad magic)", path)
        major, minor = b.u8(), b.u8()
        if major != 3:
            error("%s: CRAM %d.%d unsupported (only 3.x)", path, major, minor)
        b.bytes(20)  # file id
        self._b = b
        self.refs: List[str] = []
        self.ref_lens: List[int] = []
        self._read_sam_header()

    # ---- container / block plumbing

    def _container_header(self, b: _Buf):
        length = b.i32()
        ref_id = b.itf8_signed()
        start = b.itf8()
        span = b.itf8()
        nrec = b.itf8()
        b.ltf8()  # record counter
        b.ltf8()  # bases
        nblocks = b.itf8()
        nland = b.itf8()
        for _ in range(nland):
            b.itf8()
        b.bytes(4)  # CRC32
        return length, ref_id, start, span, nrec, nblocks

    def _block(self, b: _Buf):
        method = b.u8()
        ctype = b.u8()
        cid = b.itf8()
        csize = b.itf8()
        rsize = b.itf8()
        payload = b.bytes(csize)
        b.bytes(4)  # CRC
        if method == RAW:
            data = payload
        elif method == GZIP:
            data = gzip.decompress(payload)
        elif method == BZIP2:
            import bz2

            data = bz2.decompress(payload)
        elif method == LZMA:
            import lzma

            data = lzma.decompress(payload)
        elif method == RANS:
            from demuxlet_tpu_torch.io import rans

            data = rans.decompress(payload)
        elif method in (5, 6, 7, 8):
            # CRAM 3.1 codec ids (5 rANS-Nx16, 6 adaptive arithmetic,
            # 7 fqzcomp, 8 name tokeniser): a 3.1 file is structurally a
            # 3.x container stream, so it dies HERE, not at the version
            # gate — name the version so the user re-encodes instead of
            # suspecting corruption
            error(
                "%s: CRAM 3.1 codec unsupported (method %d: "
                "rANS-Nx16/arith/fqzcomp/tok3); re-encode as CRAM 3.0 "
                "(e.g. samtools view -O cram,version=3.0)", self.path,
                method,
            )
        else:
            error("CRAM: block compression method %d not supported", method)
        if len(data) != rsize:
            error("CRAM: block size mismatch (%d != %d)", len(data), rsize)
        return ctype, cid, data

    def _read_sam_header(self):
        _len, _rid, _st, _sp, _nrec, nblocks = self._container_header(self._b)
        ctype, _cid, data = self._block(self._b)
        if ctype != FILE_HEADER:
            error("CRAM: expected SAM header block")
        hb = _Buf(data)
        tlen = hb.i32()
        text = hb.bytes(tlen).decode("utf-8", "replace")
        for _ in range(nblocks - 1):
            self._block(self._b)
        for line in text.split("\n"):
            if line.startswith("@SQ"):
                name, ln = None, 0
                for tok in line.split("\t")[1:]:
                    if tok.startswith("SN:"):
                        name = tok[3:]
                    elif tok.startswith("LN:"):
                        ln = int(tok[3:])
                if name:
                    self.refs.append(name)
                    self.ref_lens.append(ln)

    # ---- compression header

    def _parse_compression_header(self, data: bytes):
        b = _Buf(data)
        pres = {"RN": True, "AP": True, "RR": True}
        sm = None
        td: List[List[Tuple[str, str]]] = []
        b.itf8()  # preservation map byte size
        for _ in range(b.itf8()):
            key = b.bytes(2).decode()
            if key in ("RN", "AP", "RR"):
                pres[key] = bool(b.u8())
            elif key == "SM":
                sm = b.bytes(5)
            elif key == "TD":
                blob = b.bytes(b.itf8())
                for entry in blob.split(b"\x00")[:-1]:
                    tags = []
                    for i in range(0, len(entry), 3):
                        tags.append(
                            (entry[i : i + 2].decode(), chr(entry[i + 2]))
                        )
                    td.append(tags)
                if blob == b"":
                    td = [[]]
            else:
                error("CRAM: unknown preservation key %s", key)
        if not td:
            td = [[]]
        b.itf8()  # data series map byte size
        ds: Dict[str, Encoding] = {}
        for _ in range(b.itf8()):
            key = b.bytes(2).decode()
            codec = b.itf8()
            params = b.bytes(b.itf8())
            ds[key] = Encoding(codec, params)
        b.itf8()  # tag encoding map byte size
        te: Dict[int, Encoding] = {}
        for _ in range(b.itf8()):
            k = b.itf8()
            codec = b.itf8()
            params = b.bytes(b.itf8())
            te[k] = Encoding(codec, params)
        return pres, sm, td, ds, te

    def _sub_matrix_fn(self, sm: Optional[bytes]):
        """Substitution matrix: per reference base (ACGTN order), one byte
        packing the 2-bit codes assigned to the other 4 bases by priority.
        Returns {ref_base: "b0b1b2b3"} with index == substitution code."""
        table: Dict[str, str] = {}
        for i, rb in enumerate(BASES):
            others = [c for c in BASES if c != rb][:4]
            if sm is None:
                table[rb] = "".join(others)
            else:
                byte = sm[i]
                row = [""] * 4
                for j, ob in enumerate(others):
                    code = (byte >> (6 - 2 * j)) & 0x3
                    row[code] = ob
                table[rb] = "".join(row)
        return table

    def __iter__(self) -> Iterator[CramRead]:
        b = self._b
        while b.o + 4 <= len(b.d):
            start_o = b.o
            length, ref_id, a_start, a_span, nrec, nblocks = (
                self._container_header(b)
            )
            body_start = b.o
            if nrec == 0:  # EOF container
                b.o = body_start + length
                continue
            ctype, _cid, chdata = self._block(b)
            if ctype != COMPRESSION_HEADER:
                error("CRAM: expected compression header block")
            pres, sm, td, ds, te = self._parse_compression_header(chdata)
            smt = self._sub_matrix_fn(sm)
            # slices until container body consumed
            while b.o < body_start + length:
                yield from self._decode_slice(b, pres, smt, td, ds, te)
            b.o = body_start + length

    def _decode_slice(self, b: _Buf, pres, smt, td, ds, te):
        ctype, _cid, sdata = self._block(b)
        if ctype != SLICE_HEADER:
            error("CRAM: expected slice header block")
        sb = _Buf(sdata)
        ref_id = sb.itf8_signed()
        a_start = sb.itf8()
        sb.itf8()  # span
        nrec = sb.itf8()
        sb.ltf8()  # counter
        # CRAM 3.0 slice header: 'number of blocks' (core + external),
        # then a separately-counted content-id array (externals only).
        nblocks = sb.itf8()
        ncids = sb.itf8()
        cids = [sb.itf8() for _ in range(ncids)]
        sb.itf8_signed()  # embedded ref id
        sb.bytes(16)  # MD5
        streams: Dict[int, _Buf] = {}
        core = _Bits(b"")
        for _ in range(nblocks):
            btype, bcid, bdata = self._block(b)
            if btype == CORE:
                core = _Bits(bdata)
            else:
                streams[bcid] = _Buf(bdata)

        def series(key: str) -> _Series:
            enc = ds.get(key)
            if enc is None:
                error("CRAM: data series %s missing", key)
            return _Series(enc, streams, core)

        S = {
            k: series(k)
            for k in ("BF", "CF", "RL", "AP", "RG", "TL")
            if k in ds
        }
        opt = {
            k: _Series(ds[k], streams, core)
            for k in (
                "RN", "RI", "MF", "NS", "NP", "TS", "NF", "FN", "FC", "FP",
                "DL", "BS", "IN", "SC", "HC", "PD", "RS", "BA", "QS", "MQ",
                "BB", "QQ",
            )
            if k in ds
        }
        tag_series = {k: _Series(v, streams, core) for k, v in te.items()}

        prev_pos = a_start
        for _ in range(nrec):
            bf = S["BF"].read_int()
            cf = S["CF"].read_int()
            rid = ref_id
            if ref_id == -2 and "RI" in opt:
                rid = opt["RI"].read_int()
            rl = S["RL"].read_int()
            ap = S["AP"].read_int()
            if pres.get("AP", True):
                pos1 = prev_pos + ap
                prev_pos = pos1
            else:
                pos1 = ap
            S["RG"].read_int()
            if pres.get("RN", True) and "RN" in opt:
                opt["RN"].read_array()
            if cf & 0x2:  # detached
                if "MF" in opt:
                    opt["MF"].read_int()
                if not pres.get("RN", True) and "RN" in opt:
                    opt["RN"].read_array()
                if "NS" in opt:
                    opt["NS"].read_int()
                if "NP" in opt:
                    opt["NP"].read_int()
                if "TS" in opt:
                    opt["TS"].read_int()
            elif cf & 0x4:  # mate downstream
                if "NF" in opt:
                    opt["NF"].read_int()
            tl = S["TL"].read_int()
            tags = {}
            for tag, typ in td[tl] if 0 <= tl < len(td) else []:
                key = (ord(tag[0]) << 16) | (ord(tag[1]) << 8) | ord(typ)
                ts = tag_series.get(key)
                if ts is None:
                    error("CRAM: tag %s:%s has no encoding", tag, typ)
                raw = ts.read_array()
                if typ == "Z":
                    tags[tag] = raw.decode("ascii", "replace")
            feats: List[Feature] = []
            quals = b""
            bases = None
            mq = 0
            if not (bf & 0x4):  # mapped
                fn = opt["FN"].read_int()
                fpos = 0
                for _f in range(fn):
                    fc = chr(opt["FC"].read_byte())
                    fpos += opt["FP"].read_int()
                    if fc == "X":
                        code = opt["BS"].read_byte()
                        feats.append(Feature("X", fpos, _SubCode(smt, code)))
                    elif fc == "D":
                        feats.append(Feature("D", fpos, opt["DL"].read_int()))
                    elif fc == "N":
                        feats.append(Feature("N", fpos, opt["RS"].read_int()))
                    elif fc == "I":
                        feats.append(Feature("I", fpos, opt["IN"].read_array()))
                    elif fc == "S":
                        feats.append(Feature("S", fpos, opt["SC"].read_array()))
                    elif fc == "i":
                        opt["BA"].read_byte()
                        feats.append(Feature("i", fpos, 1))
                    elif fc == "b":
                        feats.append(Feature("b", fpos, opt["BB"].read_array()))
                    elif fc == "q":
                        opt["QQ"].read_array()
                    elif fc == "Q":
                        opt["QS"].read_byte()
                    elif fc == "H":
                        opt["HC"].read_int()
                    elif fc == "P":
                        opt["PD"].read_int()
                    elif fc == "B":
                        # base + qual at one position: consumes a read
                        # base AND a ref position — semantically a
                        # 1-length 'b' run (dropping the stored base
                        # would silently resolve to the ref base). The
                        # qual byte rides on the feature: when quals are
                        # not preserved wholesale (no CF 0x1), it is the
                        # only source of BQ at this position.
                        bb = opt["BA"].read_byte()
                        qb = opt["QS"].read_byte()
                        feats.append(
                            Feature("b", fpos, bytes([bb]), bytes([qb]))
                        )
                    else:
                        error("CRAM: feature code %r unsupported", fc)
                mq = opt["MQ"].read_int() if "MQ" in opt else 0
                if cf & 0x1:
                    quals = opt["QS"].read_bytes(rl)
            else:
                bases = opt["BA"].read_bytes(rl) if "BA" in opt else b"N" * rl
                if cf & 0x1:
                    quals = opt["QS"].read_bytes(rl)
            yield CramRead(
                tid=rid,
                pos=pos1 - 1,
                mapq=mq,
                flag=bf,
                l_qseq=rl,
                features=feats,
                quals=quals,
                tags=tags,
                bases=bases,
            )

    def records(self) -> Iterator[CramRead]:
        return iter(self)

    def filtered(self) -> Iterator[CramRead]:
        """MQ/flag filter (sam_filtered_reader.cpp:284-296 semantics)."""
        for r in self:
            self.n_read += 1
            if r.mapq < self.min_mq or (r.flag & self.excl_flag):
                self.n_skip += 1
                continue
            yield r

    def close(self) -> None:
        pass


class _SubCode:
    """Substitution: resolves to a base given the reference base at the
    feature position (for demuxlet: the VCF REF allele)."""

    __slots__ = ("table", "code")

    def __init__(self, table: Dict[str, str], code: int):
        self.table = table
        self.code = code

    def __call__(self, ref_base: str) -> str:
        row = self.table.get(ref_base.upper(), "NNNN")
        return row[self.code] if self.code < len(row) else "N"
