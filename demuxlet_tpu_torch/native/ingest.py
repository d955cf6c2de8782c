"""ctypes bindings for the native C++ ingest (_ingest.so).

Replaces io/bam.py + host/pileup.py on the production path: multithreaded
BGZF inflate + single-pass streaming pileup (ingest.cpp). Falls back to the
pure Python ingest when the library can't be built/loaded.
"""

from __future__ import annotations

import ctypes as C
import os
from typing import Optional

import numpy as np

from demuxlet_tpu_torch.host.csr import CsrPileup
from demuxlet_tpu_torch.host.pileup import IngestCounters, _check_chrom_order
from demuxlet_tpu_torch.utils.logging_utils import error, notice

_LIB = None
_LOAD_FAILED = False


def _load():
    global _LIB, _LOAD_FAILED
    if _LIB is not None or _LOAD_FAILED:
        return _LIB
    try:
        from demuxlet_tpu_torch.native.build import build

        lib = C.CDLL(build())
    except Exception:
        _LOAD_FAILED = True
        return None
    lib.dmx_ingest_bam.restype = C.c_void_p
    lib.dmx_ingest_bam.argtypes = [
        C.c_char_p,  # path
        C.c_int32,  # n_chroms
        C.c_char_p,  # chrom_concat
        C.POINTER(C.c_int64),  # chrom_off
        C.POINTER(C.c_int64),  # chrom_ptr
        C.POINTER(C.c_int64),  # snp_pos
        C.POINTER(C.c_int32),  # snp_ids
        C.POINTER(C.c_uint8),  # snp_ref
        C.POINTER(C.c_uint8),  # snp_alt
        C.c_char_p,  # tag_group
        C.c_char_p,  # tag_umi
        C.c_int32,  # cap_bq
        C.c_int32,  # min_bq
        C.c_int32,  # min_td
        C.c_int32,  # min_mq
        C.c_int32,  # excl_flag
        C.c_char_p,  # grp_concat
        C.POINTER(C.c_int64),  # grp_off
        C.c_int64,  # n_group
        C.c_int32,  # n_threads
        C.c_int32,  # n_shards
        C.c_int32,  # shard_id
        C.c_int64,  # sam_verbose (0 = quiet)
        C.c_int64,  # n_regions
        C.POINTER(C.c_int32),  # reg_chrom (panel idx)
        C.POINTER(C.c_int64),  # reg_beg0
        C.POINTER(C.c_int64),  # reg_end0 (exclusive)
    ]
    lib.dmx_error.restype = C.c_char_p
    lib.dmx_error.argtypes = [C.c_void_p]
    lib.dmx_n_cells.restype = C.c_int64
    lib.dmx_n_cells.argtypes = [C.c_void_p]
    lib.dmx_n_obs.restype = C.c_int64
    lib.dmx_n_obs.argtypes = [C.c_void_p]
    lib.dmx_barcode.restype = C.c_char_p
    lib.dmx_barcode.argtypes = [C.c_void_p, C.c_int64]
    lib.dmx_get_cell_counters.argtypes = [C.c_void_p] + [
        C.POINTER(C.c_int64)
    ] * 3
    lib.dmx_get_obs.argtypes = [
        C.c_void_p,
        C.POINTER(C.c_int32),
        C.POINTER(C.c_int32),
        C.POINTER(C.c_uint8),
        C.POINTER(C.c_uint8),
    ]
    lib.dmx_get_counters.argtypes = [C.c_void_p, C.POINTER(C.c_int64)]
    lib.dmx_free.argtypes = [C.c_void_p]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _p64(a):
    return a.ctypes.data_as(C.POINTER(C.c_int64))


def _bam_refs_len(path: str):
    """Header-only BAM parse: [(chrom, length)] in header order."""
    import struct
    import zlib

    try:
        return _bam_refs_len_raw(path)
    except (zlib.error, EOFError, OSError, ValueError, struct.error,
            MemoryError) as e:
        error("%s: cannot read BAM header (%s)", path, e)


def _bam_refs_len_raw(path: str):
    import gzip
    import struct

    with open(path, "rb") as probe:
        magic = probe.read(2)
    op = gzip.open if magic == b"\x1f\x8b" else open
    with op(path, "rb") as fh:
        if fh.read(4) != b"BAM\x01":
            error("%s is not a BAM file (bad magic)", path)
        (l_text,) = struct.unpack("<i", fh.read(4))
        fh.read(l_text)
        (n_ref,) = struct.unpack("<i", fh.read(4))
        refs = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", fh.read(4))
            name = fh.read(l_name)[:-1].decode()
            (l_ref,) = struct.unpack("<i", fh.read(4))
            refs.append((name, l_ref))
        return refs


def _bam_refs(path: str):
    """Header-only BAM parse for the chromosome-order check."""
    return [name for name, _ in _bam_refs_len(path)]


def build_pileup(
    path: str,
    table,
    tag_group: str = "CB",
    tag_umi: str = "UB",
    cap_bq: int = 40,
    min_bq: int = 13,
    min_td: int = 0,
    min_mq: int = 20,
    excl_flag: int = 0x0F04,
    group_set: Optional[set] = None,
    n_threads: int = 0,
    n_shards: int = 1,
    shard_id: int = 0,
    sam_verbose: int = 0,
    regions=None,
):
    """regions: optional [(chrom, beg1, end0)] genome-shard regions. The
    scan seeks each region via the BAI linear index (reading ~regions/genome
    of the file), reads are counted by the region owning their start, and
    observations partition exactly by SNP position (the SNP table should be
    pre-filtered to the same regions — see io/vcf.filter_snp_table)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native ingest library unavailable")
    is_cram = False
    with open(path, "rb") as fh:
        is_cram = fh.read(4) == b"CRAM"
    if is_cram:
        from demuxlet_tpu_torch.io.cram import CramReader

        _check_chrom_order(CramReader(path).refs, table.chrom_names)
    else:
        _check_chrom_order(_bam_refs(path), table.chrom_names)

    # per-chromosome sorted SNP arrays in table.chrom_names order
    chrom_arr = np.asarray(table.chroms)
    pos_parts, id_parts, ptr = [], [], [0]
    for ch in table.chrom_names:
        idx = np.nonzero(chrom_arr == ch)[0]
        pos = table.pos0[idx]
        order = np.argsort(pos, kind="stable")
        pos_parts.append(pos[order].astype(np.int64))
        id_parts.append(idx[order].astype(np.int32))
        ptr.append(ptr[-1] + len(idx))
    snp_pos = (
        np.concatenate(pos_parts) if pos_parts else np.zeros(0, np.int64)
    )
    snp_ids = (
        np.concatenate(id_parts) if id_parts else np.zeros(0, np.int32)
    )
    chrom_ptr = np.asarray(ptr, dtype=np.int64)

    names = [c.encode() for c in table.chrom_names]
    chrom_concat = b"".join(names)
    chrom_off = np.zeros(len(names) + 1, dtype=np.int64)
    np.cumsum([len(n) for n in names], out=chrom_off[1:])

    snp_ref = np.ascontiguousarray(table.ref, dtype=np.uint8)
    snp_alt = np.ascontiguousarray(table.alt, dtype=np.uint8)

    if group_set is not None:
        gitems = [g.encode() for g in group_set]
        grp_concat = b"".join(gitems)
        grp_off = np.zeros(len(gitems) + 1, dtype=np.int64)
        if gitems:
            np.cumsum([len(g) for g in gitems], out=grp_off[1:])
        n_group = len(gitems)
        grp_args = (grp_concat, _p64(grp_off), n_group)
    else:
        grp_args = (None, None, 0)

    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)

    if regions:
        cidx = {c: i for i, c in enumerate(table.chrom_names)}
        rc, rb, re_ = [], [], []
        for chrom, beg1, end0 in regions:
            # a region chrom absent from the panel (no SNPs there) still
            # keeps ownership mode active: sentinel -1 matches no read's
            # panel chrom, so this shard owns nothing on it — the reads
            # are skipped everywhere, exactly like an unsharded run
            rc.append(cidx.get(chrom, -1))
            rb.append(beg1 - 1)
            re_.append(end0)  # 1-based inclusive end == 0-based exclusive
        rc = np.asarray(rc, np.int32)
        rb = np.asarray(rb, np.int64)
        re_ = np.asarray(re_, np.int64)
        reg_args = (
            len(rc),
            rc.ctypes.data_as(C.POINTER(C.c_int32)),
            _p64(rb),
            _p64(re_),
        )
    else:
        reg_args = (0, None, None, None)

    h = lib.dmx_ingest_bam(
        path.encode(),
        len(names),
        chrom_concat,
        _p64(chrom_off),
        _p64(chrom_ptr),
        _p64(snp_pos),
        snp_ids.ctypes.data_as(C.POINTER(C.c_int32)),
        snp_ref.ctypes.data_as(C.POINTER(C.c_uint8)),
        snp_alt.ctypes.data_as(C.POINTER(C.c_uint8)),
        tag_group.encode() if tag_group else b"",
        tag_umi.encode() if tag_umi else b"",
        cap_bq,
        min_bq,
        min_td,
        min_mq,
        excl_flag,
        grp_args[0],
        grp_args[1],
        grp_args[2],
        n_threads,
        n_shards,
        shard_id,
        sam_verbose,
        reg_args[0],
        reg_args[1],
        reg_args[2],
        reg_args[3],
    )
    try:
        err = lib.dmx_error(h)
        if err:
            error("native ingest: %s", err.decode())
        ncells = lib.dmx_n_cells(h)
        nobs = lib.dmx_n_obs(h)
        barcodes = [lib.dmx_barcode(h, i).decode() for i in range(ncells)]
        totl = np.zeros(ncells, np.int64)
        pas = np.zeros(ncells, np.int64)
        uniq = np.zeros(ncells, np.int64)
        if ncells:
            lib.dmx_get_cell_counters(h, _p64(totl), _p64(pas), _p64(uniq))
        oc = np.zeros(nobs, np.int32)
        os_ = np.zeros(nobs, np.int32)
        oa = np.zeros(nobs, np.uint8)
        ob = np.zeros(nobs, np.uint8)
        if nobs:
            lib.dmx_get_obs(
                h,
                oc.ctypes.data_as(C.POINTER(C.c_int32)),
                os_.ctypes.data_as(C.POINTER(C.c_int32)),
                oa.ctypes.data_as(C.POINTER(C.c_uint8)),
                ob.ctypes.data_as(C.POINTER(C.c_uint8)),
            )
        cc = np.zeros(11, np.int64)
        lib.dmx_get_counters(h, _p64(cc))
    finally:
        lib.dmx_free(h)

    csr = CsrPileup.from_arrays(
        table.sample_ids,
        table.nsnps,
        barcodes,
        totl,
        pas,
        uniq,
        oc.astype(np.int64),
        os_.astype(np.int64),
        oa,
        ob,
    )
    ctr = IngestCounters(
        n_read=int(cc[0]),
        n_skip=int(cc[1]),
        n_skip_bcd=int(cc[2]),
        n_tmp=int(cc[3]),
        n_multi_snps=int(cc[4]),
        n_pass=int(cc[5]),
        n_redundant=int(cc[6]),
        n_lq=int(cc[7]),
        n_n=int(cc[8]),
        n_no_gtag=int(cc[9]),
        n_no_utag=int(cc[10]),
    )
    notice("Native ingest: %d reads, %d cells, %d unique observations",
           ctr.n_read, len(barcodes), nobs)
    return csr, ctr
