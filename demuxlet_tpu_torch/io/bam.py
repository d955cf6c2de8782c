"""SAM/BAM alignment reading and the per-SNP pileup primitive.

Host-side replacement for the reference's SAMFilteredReader
(sam_filtered_reader.cpp) and the pileup primitive
bam_get_base_and_qual_and_read_and_qual (hts_utils.cpp:279-359). The CIGAR
walk reproduces the reference's exact op semantics, including its quirks:
only 'M' consumes both read+ref in the walk ('='/'X' advance NOTHING — a
reference behavior kept for parity), 'D'/'N' consume ref and yield no base,
'S'/'I' consume read.

BAM is parsed directly from the BGZF stream (gzip module handles member
concatenation); CRAM is not supported (requires reference-based codecs) and
raises a clear error.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

from demuxlet_tpu_torch.utils.logging_utils import error

SEQ_NT16 = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"

READ_INDEX_NA = -1  # hts_utils.h:125


@dataclass
class AlignedRead:
    tid: int  # reference id in the file's header order (-1 unmapped)
    pos: int  # 0-based leftmost
    mapq: int
    flag: int
    l_qseq: int
    cigar: List[Tuple[int, int]]  # (op_index, length)
    seq: str
    qual: bytes  # raw phred values (no +33)
    tags: dict  # tag -> value (only Z-type strings retained)

    def endpos(self) -> int:
        """bam_endpos: pos + reference-consumed length (M/D/N/=/X)."""
        rlen = 0
        for op, ln in self.cigar:
            if op in (0, 2, 3, 7, 8):  # M D N = X
                rlen += ln
        return self.pos + (rlen if rlen else 1)

    def base_qual_at(self, gpos: int, ref_base: str = "N") -> Tuple[str, int, int]:
        """The reference pileup primitive (hts_utils.cpp:279-359).

        Returns (base_char, phred_qual, rpos); rpos == READ_INDEX_NA means
        no informative base (deletion/refskip/out of read). ref_base is
        unused here (BAM stores bases); the CRAM read type resolves match
        positions through it.
        """
        cpos = self.pos
        rpos = 0
        base = "N"
        qual = 0
        if not self.cigar:
            return base, qual, READ_INDEX_NA
        hit = False
        for op, ln in self.cigar:
            ch = CIGAR_OPS[op]
            if ch == "M":
                if cpos <= gpos <= cpos + ln - 1:
                    rpos += gpos - cpos
                    hit = True
                    break
                cpos += ln
                rpos += ln
            elif ch in ("D", "N"):
                if cpos <= gpos <= cpos + ln - 1:
                    rpos = -1
                    hit = True
                    break
                cpos += ln
            elif ch in ("S", "I"):
                rpos += ln
            # H, P, '=', 'X': no-ops (reference behavior, hts_utils.cpp:304-328)
        del hit
        if 0 <= rpos <= self.l_qseq:
            if rpos < len(self.seq):
                base = self.seq[rpos]
                qual = self.qual[rpos] if rpos < len(self.qual) else 0
            else:
                base = "."
        else:
            return base, qual, READ_INDEX_NA
        if rpos >= self.l_qseq:
            return ".", qual, READ_INDEX_NA
        return base, qual, rpos


class AlignmentReader:
    """Sequential SAM/BAM reader with the reference's MQ/flag filter."""

    def __init__(self, path: str, min_mq: int = 20, excl_flag: int = 0x0F04):
        self.path = path
        self.min_mq = min_mq
        self.excl_flag = excl_flag
        self.refs: List[str] = []
        self.ref_lens: List[int] = []
        self.n_read = 0
        self.n_skip = 0
        if path.endswith(".cram"):
            error(
                "CRAM input is not supported by this build (requires "
                "reference-based codecs); convert to BAM first"
            )
        with open(path, "rb") as probe:
            magic = probe.read(4)
        if magic[:2] == b"\x1f\x8b":
            self._mode = "bam"
        elif magic == b"BAM\x01":
            self._mode = "ubam"  # uncompressed BAM
        else:
            self._mode = "sam"
        self._open()

    def _open(self) -> None:
        if self._mode == "bam":
            self._fh = gzip.open(self.path, "rb")
            self._parse_bam_header()
        elif self._mode == "ubam":
            self._fh = open(self.path, "rb")
            self._parse_bam_header()
        else:
            self._fh = open(self.path, "rt", encoding="utf-8")
            self._ref_index = {}
            self._pending: Optional[str] = None
            while True:
                line = self._fh.readline()
                if not line:
                    break
                if line.startswith("@"):
                    if line.startswith("@SQ"):
                        name, ln = None, 0
                        for tok in line.rstrip("\n").split("\t")[1:]:
                            if tok.startswith("SN:"):
                                name = tok[3:]
                            elif tok.startswith("LN:"):
                                ln = int(tok[3:])
                        if name is not None:
                            self._ref_index[name] = len(self.refs)
                            self.refs.append(name)
                            self.ref_lens.append(ln)
                else:
                    self._pending = line
                    break

    def _parse_bam_header(self) -> None:
        fh = self._fh
        magic = fh.read(4)
        if magic != b"BAM\x01":
            error("%s is not a BAM file (bad magic)", self.path)
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)  # header text (unused; @SQ duplicated in binary)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            name = fh.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", fh.read(4))
            self.refs.append(name)
            self.ref_lens.append(l_ref)

    # ---- record iteration ----

    def records(self) -> Iterator[AlignedRead]:
        """All records, unfiltered (caller applies passed_filter)."""
        if self._mode in ("bam", "ubam"):
            yield from self._bam_records()
        else:
            yield from self._sam_records()

    def filtered(self) -> Iterator[AlignedRead]:
        """Records passing the MQ/flag filter (sam_filtered_reader.cpp:284-296);
        maintains n_read/n_skip counters."""
        for r in self.records():
            self.n_read += 1
            if r.mapq < self.min_mq or (r.flag & self.excl_flag):
                self.n_skip += 1
                continue
            yield r

    def _bam_records(self) -> Iterator[AlignedRead]:
        fh = self._fh
        while True:
            hdr = fh.read(4)
            if len(hdr) < 4:
                return
            (block_size,) = struct.unpack("<i", hdr)
            data = fh.read(block_size)
            if len(data) < block_size:
                error("truncated BAM record in %s", self.path)
            yield _decode_bam_record(data)

    def _sam_records(self) -> Iterator[AlignedRead]:
        def parse(line: str) -> Optional[AlignedRead]:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 11:
                return None
            flag = int(cols[1])
            rname = cols[2]
            tid = self._ref_index.get(rname, -1) if rname != "*" else -1
            pos = int(cols[3]) - 1
            mapq = int(cols[4])
            cigar: List[Tuple[int, int]] = []
            if cols[5] != "*":
                num = ""
                for ch in cols[5]:
                    if ch.isdigit():
                        num += ch
                    else:
                        cigar.append((CIGAR_OPS.index(ch), int(num)))
                        num = ""
            seq = cols[9].upper() if cols[9] != "*" else ""
            qual = (
                bytes(max(0, ord(c) - 33) for c in cols[10])
                if cols[10] != "*"
                else b"\xff" * len(seq)
            )
            tags = {}
            for tok in cols[11:]:
                parts = tok.split(":", 2)
                if len(parts) == 3 and parts[1] == "Z":
                    tags[parts[0]] = parts[2]
            return AlignedRead(
                tid=tid,
                pos=pos,
                mapq=mapq,
                flag=flag,
                l_qseq=len(seq),
                cigar=cigar,
                seq=seq,
                qual=qual,
                tags=tags,
            )

        if self._pending is not None:
            r = parse(self._pending)
            self._pending = None
            if r is not None:
                yield r
        for line in self._fh:
            if line.startswith("@"):
                continue
            r = parse(line)
            if r is not None:
                yield r

    def close(self) -> None:
        self._fh.close()


def _decode_bam_record(data: bytes) -> AlignedRead:
    (
        tid,
        pos,
        l_read_name,
        mapq,
        _bin,
        n_cigar,
        flag,
        l_seq,
        _next_tid,
        _next_pos,
        _tlen,
    ) = struct.unpack_from("<iiBBHHHiiii", data, 0)
    off = 32
    off += l_read_name  # skip read name (NUL-terminated)
    cigar = []
    for _ in range(n_cigar):
        (c,) = struct.unpack_from("<I", data, off)
        cigar.append((c & 0xF, c >> 4))
        off += 4
    nseq_bytes = (l_seq + 1) // 2
    seq_chars = []
    for i in range(l_seq):
        b = data[off + (i >> 1)]
        code = (b >> 4) if (i & 1) == 0 else (b & 0xF)
        seq_chars.append(SEQ_NT16[code])
    seq = "".join(seq_chars)
    off += nseq_bytes
    qual = data[off : off + l_seq]
    off += l_seq
    tags = {}
    cg_ops = None
    n = len(data)
    while off + 3 <= n:
        tag = data[off : off + 2].decode("ascii", "replace")
        typ = chr(data[off + 2])
        off += 3
        if typ == "Z" or typ == "H":
            end = data.index(b"\x00", off)
            if typ == "Z":
                tags[tag] = data[off:end].decode("ascii", "replace")
            off = end + 1
        elif typ == "A":
            off += 1
        elif typ in "cC":
            off += 1
        elif typ in "sS":
            off += 2
        elif typ in "iIf":
            off += 4
        elif typ == "B":
            sub = chr(data[off])
            (cnt,) = struct.unpack_from("<I", data, off + 1)
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            if tag == "CG" and sub == "I" and cnt:
                cg_ops = struct.unpack_from("<%dI" % cnt, data, off + 5)
            off += 5 + cnt * size
        else:
            break
    # long-CIGAR records (>65535 ops): BAM stores a dummy `l_seqS spanN`
    # CIGAR and ships the real one in a CG:B,I aux tag; htslib (the
    # reference's reader) restores it transparently (sam.c), so must we —
    # the dummy soft-clip would otherwise silently mis-pile every SNP the
    # read covers. Trigger condition mirrors htslib exactly.
    if (
        cg_ops is not None
        and n_cigar == 2
        and len(cigar) == 2
        and cigar[0] == (4, l_seq)  # S of l_qseq
        and cigar[1][0] == 3  # N
    ):
        cigar = [(c & 0xF, c >> 4) for c in cg_ops]
    return AlignedRead(
        tid=tid,
        pos=pos,
        mapq=mapq,
        flag=flag,
        l_qseq=l_seq,
        cigar=cigar,
        seq=seq,
        qual=qual,
        tags=tags,
    )
