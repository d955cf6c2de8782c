"""BCF2.2 binary VCF reading (htslib vcf.h record layout, from scratch).

Host-side analog of the reference's bcf_read path (bcf_chunked_reader.cpp ->
htslib bcf_read/bcf_unpack). Decodes BCF binary records into the same
VariantRecord (string-field) form the text VcfReader produces, so the
GT/GP/PL posterior conversion (host/genotypes.py) runs unchanged on either
input. BGZF framing is handled by Python's gzip (concatenated members).

Typed-value encoding (BCF spec 6.3.3): descriptor byte (len << 4) | type;
len == 15 -> followed by a typed scalar with the actual count. Types:
1=int8, 2=int16, 3=int32, 5=float32, 7=char. Missing / END_OF_VECTOR use
the type's reserved values (e.g. int8 0x80 / 0x81).
"""

from __future__ import annotations

import gzip
import struct
from typing import IO, Iterator, List, Optional

import numpy as np

from demuxlet_tpu_torch.io.vcf import VariantRecord
from demuxlet_tpu_torch.utils.logging_utils import error

_MISSING = {1: -128, 2: -32768, 3: -2147483648}
_EOV = {1: -127, 2: -32767, 3: -2147483647}
_SIZE = {1: 1, 2: 2, 3: 4, 5: 4, 7: 1}
_FMT = {1: "b", 2: "h", 3: "i", 5: "f"}

_FLOAT_MISSING = 0x7F800001
_FLOAT_EOV = 0x7F800002


class _Cursor:
    __slots__ = ("data", "off")

    def __init__(self, data: bytes, off: int = 0):
        self.data = data
        self.off = off

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def scalar(self, typ: int):
        v = struct.unpack_from("<" + _FMT[typ], self.data, self.off)[0]
        self.off += _SIZE[typ]
        return v

    def typed_descriptor(self):
        d = self.u8()
        typ = d & 0xF
        ln = d >> 4
        if ln == 15:
            lt = self.u8()
            ln = self.scalar(lt & 0xF)
        return typ, ln

    def typed_ints(self) -> List[int]:
        typ, ln = self.typed_descriptor()
        if typ == 0 or ln == 0:
            return []
        out = []
        for _ in range(ln):
            out.append(self.scalar(typ))
        return out

    def typed_string(self) -> str:
        typ, ln = self.typed_descriptor()
        if typ == 0 or ln == 0:
            return ""
        if typ != 7:
            # tolerate non-char by skipping
            self.off += ln * _SIZE[typ]
            return ""
        s = self.data[self.off : self.off + ln].decode("ascii", "replace")
        self.off += ln
        return s

    def skip_typed(self) -> None:
        typ, ln = self.typed_descriptor()
        if typ:
            self.off += ln * _SIZE[typ]


def _int_to_str(v: int, typ: int) -> str:
    if v == _MISSING[typ]:
        return "."
    return str(v)


def _read_csi(path: str):
    """Parse a .csi (BGZF-compressed; CSI has no linear index — each bin
    carries loff, the voff of its first overlapping record).

    Returns (starts, linear): per-ref smallest data voff (0 = none) and
    synthetic 16kb linear windows built from leaf-bin loffs (same
    contract as the C++ parse_csi_starts in native/ingest.cpp). None on
    an unreadable/foreign/truncated index (callers full-scan instead)."""
    try:
        return _read_csi_raw(path)
    except (struct.error, IndexError, ValueError, MemoryError,
            EOFError, OSError):
        return None


def _read_csi_raw(path: str):
    try:
        with gzip.open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return None
    if data[:4] != b"CSI\x01":
        return None
    pos = [4]

    def u32():
        v = struct.unpack_from("<i", data, pos[0])[0]
        pos[0] += 4
        return v

    def u64():
        v = struct.unpack_from("<Q", data, pos[0])[0]
        pos[0] += 8
        return v

    min_shift, depth, l_aux = u32(), u32(), u32()
    if not (4 <= min_shift <= 31) or depth > 10:
        return None
    pos[0] += l_aux
    n_ref = u32()
    leaf0 = ((1 << (3 * depth)) - 1) // 7
    max_bin = ((1 << (3 * (depth + 1))) - 1) // 7
    starts = [0] * n_ref
    linear: List[List[int]] = [[] for _ in range(n_ref)]
    for r in range(n_ref):
        n_bin = u32()
        mn = 0
        for _ in range(n_bin):
            bin_ = u32()
            loff = u64()
            n_chunk = u32()
            pseudo = bin_ > max_bin
            for _ in range(n_chunk):
                beg = u64()
                u64()
                if not pseudo and (mn == 0 or beg < mn):
                    mn = beg
            if pseudo or loff == 0 or bin_ < leaf0:
                continue
            leaf = bin_ - leaf0
            if min_shift >= 14:
                w0 = (leaf << min_shift) >> 14
                w1 = ((leaf + 1) << min_shift) >> 14
            else:
                w0 = leaf >> (14 - min_shift)
                w1 = w0 + 1
            lin = linear[r]
            if len(lin) < w1:
                lin.extend([0] * (w1 - len(lin)))
            for w in range(w0, w1):
                if lin[w] == 0 or loff < lin[w]:
                    lin[w] = loff
        starts[r] = mn
    return starts, linear


class BcfReader:
    """Streaming BCF reader with the VcfReader interface."""

    def __init__(self, path: str):
        self.path = path
        self.samples: List[str] = []
        self.contigs: List[str] = []
        self._dict: List[str] = []  # FILTER/INFO/FORMAT dictionary by IDX
        self._fh: IO[bytes] = gzip.open(path, "rb")
        magic = self._fh.read(5)
        if magic != b"BCF\x02\x02":
            error("[%s] not a BCF2.2 file (bad magic %r)", path, magic)
        (l_text,) = struct.unpack("<I", self._fh.read(4))
        text = self._fh.read(l_text).rstrip(b"\x00").decode("utf-8", "replace")
        self._parse_header_text(text)

    def _parse_header_text(self, text: str) -> None:
        idx_map = {}
        id_to_idx = {}  # one shared IDX per ID across FILTER/INFO/FORMAT
        seq = 0
        saw_pass = False
        for line in text.split("\n"):
            if line.startswith("##"):
                for kind in ("FILTER", "INFO", "FORMAT"):
                    if line.startswith("##%s=<" % kind):
                        inner = line[len(kind) + 4 :].rstrip(">")
                        key = idx = None
                        for kv in _split_meta(inner):
                            if kv.startswith("ID="):
                                key = kv[3:]
                            elif kv.startswith("IDX="):
                                idx = int(kv[4:])
                        if key is None:
                            continue
                        if kind == "FILTER" and key == "PASS":
                            saw_pass = True
                        if idx is None:
                            if key in id_to_idx:
                                # BCF2 spec: an ID in multiple dictionary
                                # lines (e.g. DP in INFO+FORMAT) shares one
                                # index; do not consume a new slot.
                                idx = id_to_idx[key]
                            else:
                                if not saw_pass and seq == 0:
                                    # implicit PASS occupies IDX 0
                                    idx_map[0] = "PASS"
                                    id_to_idx["PASS"] = 0
                                    seq = 1
                                    saw_pass = True
                                idx = seq
                                seq += 1
                        else:
                            seq = max(seq, idx + 1)
                        idx_map[idx] = key
                        id_to_idx[key] = idx
                if line.startswith("##contig=<"):
                    inner = line[len("##contig=<") :].rstrip(">")
                    name = cidx = None
                    for kv in _split_meta(inner):
                        if kv.startswith("ID="):
                            name = kv[3:]
                        elif kv.startswith("IDX="):
                            cidx = int(kv[4:])
                    if name is None:
                        continue
                    if cidx is None:
                        self.contigs.append(name)
                    else:
                        # explicit contig dictionary index (rid)
                        while len(self.contigs) <= cidx:
                            self.contigs.append("?")
                        self.contigs[cidx] = name
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.samples = cols[9:]
        if 0 not in idx_map:
            idx_map[0] = "PASS"
        n = max(idx_map) + 1
        self._dict = [idx_map.get(i, "?") for i in range(n)]

    def _records_from(self, fh) -> Iterator[VariantRecord]:
        while True:
            hdr = fh.read(8)
            if len(hdr) < 8:
                return
            l_shared, l_indiv = struct.unpack("<II", hdr)
            shared = fh.read(l_shared)
            indiv = fh.read(l_indiv)
            if len(shared) < l_shared or len(indiv) < l_indiv:
                error("[%s] truncated BCF record", self.path)
            yield self._decode(shared, indiv)

    def __iter__(self) -> Iterator[VariantRecord]:
        return self._records_from(self._fh)

    def iter_regions(self, regions) -> Optional[Iterator[VariantRecord]]:
        """CSI-seeked iteration over [(chrom, beg1, end0)] regions (the
        BCF analog of VcfReader.iter_regions; htslib: bcf_itr_querys via
        hts_idx_load). Returns None without a readable .csi — the caller
        full-scans + post-filters."""
        import os

        csi = self.path + ".csi"
        if not os.path.exists(csi) or not self.contigs:
            return None
        idx = _read_csi(csi)
        if idx is None:
            return None
        return self._iter_regions_csi(idx, regions)

    def _iter_regions_csi(self, idx, regions) -> Iterator[VariantRecord]:
        from demuxlet_tpu_torch.io.bgzf import BgzfByteStream

        starts, linear = idx
        rid_of = {n: i for i, n in enumerate(self.contigs)}
        for chrom, beg1, end0 in regions:
            r = rid_of.get(chrom)
            if r is None or r >= len(starts) or starts[r] == 0:
                continue
            voff = starts[r]
            win = (beg1 - 1) >> 14
            lin = linear[r]
            if win < len(lin) and lin[win]:
                voff = max(voff, lin[win])
            fh = BgzfByteStream(self.path, voff)
            seen = False
            try:
                for rec in self._records_from(fh):
                    if rec.chrom != chrom:
                        if seen:
                            break  # sorted: past this chromosome
                        continue  # index landed before the chrom start
                    seen = True
                    if rec.pos0 + 1 > end0:
                        break
                    if rec.pos0 + 1 < beg1:
                        continue
                    yield rec
            finally:
                fh.close()

    def close(self) -> None:
        self._fh.close()

    def _decode(self, shared: bytes, indiv: bytes) -> VariantRecord:
        c = _Cursor(shared)
        rid, pos, _rlen = struct.unpack_from("<iii", shared, 0)
        (qual_bits,) = struct.unpack_from("<I", shared, 12)
        qual = struct.unpack_from("<f", shared, 12)[0]
        if qual_bits == _FLOAT_MISSING:
            qual = float("nan")
        n_allele_info = struct.unpack_from("<I", shared, 16)[0]
        n_fmt_sample = struct.unpack_from("<I", shared, 20)[0]
        n_allele = n_allele_info >> 16
        n_info = n_allele_info & 0xFFFF
        n_fmt = n_fmt_sample >> 24
        n_sample = n_fmt_sample & 0xFFFFFF
        c.off = 24
        c.typed_string()  # ID
        alleles = [c.typed_string() for _ in range(n_allele)]
        filters = [
            self._dict[i] if 0 <= i < len(self._dict) else "?"
            for i in c.typed_ints()
        ]
        for _ in range(n_info):
            c.skip_typed()  # INFO key
            c.skip_typed()  # INFO value

        # ---- per-sample FORMAT fields -> string form
        ci = _Cursor(indiv)
        fmt_keys: List[str] = []
        per_sample: List[List[str]] = [[] for _ in range(n_sample)]
        for _ in range(n_fmt):
            keys = ci.typed_ints()
            key_id = keys[0] if keys else -1
            key = (
                self._dict[key_id]
                if 0 <= key_id < len(self._dict)
                else "?"
            )
            typ, per = ci.typed_descriptor()
            fmt_keys.append(key)
            for s in range(n_sample):
                vals = []
                if typ == 7:  # char string
                    raw = ci.data[ci.off : ci.off + per]
                    ci.off += per
                    per_sample[s].append(
                        raw.split(b"\x00")[0].decode("ascii", "replace")
                    )
                    continue
                for _k in range(per):
                    if typ == 5:
                        (bits,) = struct.unpack_from("<I", ci.data, ci.off)
                        v = struct.unpack_from("<f", ci.data, ci.off)[0]
                        ci.off += 4
                        if bits == _FLOAT_EOV:
                            continue
                        vals.append("." if bits == _FLOAT_MISSING else repr(v))
                    else:
                        v = ci.scalar(typ)
                        if v == _EOV[typ]:
                            continue
                        if key == "GT":
                            vals.append(_gt_code_to_str(v))
                        else:
                            vals.append(_int_to_str(v, typ))
                if key == "GT":
                    per_sample[s].append("/".join(vals) if vals else ".")
                else:
                    per_sample[s].append(",".join(vals) if vals else ".")

        chrom = (
            self.contigs[rid] if 0 <= rid < len(self.contigs) else str(rid)
        )
        ref = alleles[0] if alleles else "N"
        alts = alleles[1:] if len(alleles) > 1 else ["."]
        return VariantRecord(
            chrom=chrom,
            pos0=pos,
            ref=ref,
            alts=alts,
            qual=qual,
            filters=filters,
            fmt_keys=fmt_keys,
            sample_fields=per_sample,
        )


def _gt_code_to_str(v: int) -> str:
    if v <= 0:
        return "."
    allele = (v >> 1) - 1
    return str(allele)


def _split_meta(inner: str) -> List[str]:
    """Split 'k=v,k2="a,b",k3=v' on commas outside quotes."""
    out, cur, q = [], [], False
    for ch in inner:
        if ch == '"':
            q = not q
        if ch == "," and not q:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def is_bcf(path: str) -> bool:
    try:
        with gzip.open(path, "rb") as fh:
            return fh.read(5) == b"BCF\x02\x02"
    except OSError:
        with open(path, "rb") as fh:
            return fh.read(5) == b"BCF\x02\x02"
