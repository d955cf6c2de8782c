"""Demux engine on PyTorch (port of ``demuxlet_tpu/models/engine.py``,
exact and fast modes, single device).

``run_compact`` follows the JAX engine's single-device branch: host
block prep on a prefetch pool (native C packer or the Python packer,
wire v2 by default), pinned-host H2D with ``non_blocking`` copies, the
fused block step (``decision.compact_step_body_exact`` in exact mode,
``decision.compact_step_body`` in fast mode) enqueued on the device, ONE
device-side concat and ONE readback at the end, then the inverse of the
coverage-sorted block permutation.

The JAX module imports JAX at the top, so its JAX-free helpers are
copied here (``compute_gp0``, ``_prefetched``, ``_to_wire``, ``_bucket``,
``_wire_cfg_for``, ``_prep_codes_blk``, ``_pack_reg``,
``_shrink_codes_blk``, ``_blocks``, ``cell_stats``);
tests/test_torch_engine.py pins each copy to the original.

Exact mode runs every pool size: V*V*A > 384 takes the tiled K7' + K6'
(``ops/pair_tiled.py``) where smaller pools take K3'. Refused, never
emulated: fast mode on pools with V*V*A > 384 (ROADMAP queue 1, item
13b); cap-BQ > 126 (the u8 codes cannot hold it: the JAX package refuses
it in fast mode and sends exact mode to the dense ``run()``, item 12).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from demuxlet_tpu_torch.host.csr import CsrPileup, build_codes_block
from demuxlet_tpu_torch.host.pileup import PileupData
from demuxlet_tpu_torch.models.outputs import CellStats
from demuxlet_tpu_torch.ops import luts
from demuxlet_tpu_torch.utils.logging_utils import DemuxError
from demuxlet_tpu_torch.models import decision as D
from demuxlet_tpu_torch.ops.pair import UNROLL_CAP, dedup_channels, extend_luts

MODES = ("exact", "fast")


def compute_gp0(gps: np.ndarray) -> np.ndarray:
    """(nsnps, nv, 3) -> (nsnps, 3): sequential sum over samples, / nv."""
    nv = gps.shape[1]
    out = np.zeros((gps.shape[0], 3), dtype=np.float64)
    for j in range(nv):
        out += gps[:, j, :]
    out /= nv
    return out


def _prefetched(pool, fn, items, depth: int = 4):
    """Yield fn(item) in order with up to `depth` evaluations in flight on
    `pool` — overlaps host block prep (numpy, releases the GIL) with device
    compute; the serial prep was the end-to-end bottleneck at 100K cells."""
    from collections import deque

    futs = deque()
    it = iter(items)
    try:
        for _ in range(depth):
            futs.append(pool.submit(fn, next(it)))
    except StopIteration:
        pass
    while futs:
        out = futs.popleft().result()
        try:
            futs.append(pool.submit(fn, next(it)))
        except StopIteration:
            pass
        yield out


def _to_wire(codes, idx_tuple):
    """Fuse (codes, delta-idx) into ONE (B, W) int32 wire buffer (the v1
    wire; unpacked on device by bitcast). Returns (wire, (S, U, K))."""
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
    return wire, (S, U, K)


def _bucket(n: int, minimum: int = 8) -> int:
    b = minimum
    while b < n:
        b *= 2
    return b


@dataclass
class DeviceTables:
    """The port's device tables for one wire config."""

    gps: torch.Tensor  # (NS, V, 3) f32
    gp0: torch.Tensor  # (NS, 3) f32
    w_ext: torch.Tensor  # (R, C) f32 deduplicated pair LUT + none row
    logf_ext: torch.Tensor  # (R, 3) f32 singlet LUT + none row
    expand: tuple  # A*9 logical channels -> rows of the deduplicated LUT


def _pad_gps(gps: np.ndarray) -> np.ndarray:
    """Zero SNPs (e.g. a genome shard without markers) get one neutral row
    so gathers stay well-formed; every slot is then masked."""
    gps = np.ascontiguousarray(gps, dtype=np.float64)
    if gps.shape[0] == 0:
        gps = np.full((1, gps.shape[1], 3), 1.0 / 3)
    return gps


def tables_from_numpy(gps, grid_alpha, cap_bq, wire_cfg, device):
    """Device tables from the numpy inputs the JAX engine takes
    (``DemuxEngine.__init__`` :124-145 and ``_fast_tables`` :429): f32
    gps and gp0, and the pair/singlet LUTs (``ops/luts.py``) with the
    A*9 columns deduplicated and, under a wire-v2 config, the rows cut to
    the run's code dictionary."""
    gps = _pad_gps(gps)
    gp0 = compute_gp0(gps)
    logf = luts.singlet_lut(cap_bq)
    w = luts.pair_lut(list(grid_alpha), cap_bq)
    cols, expand = dedup_channels(list(grid_alpha))
    if wire_cfg is not None:
        rows = list(wire_cfg.dict_codes)
        w, logf = w[rows], logf[rows]
    w_ext, logf_ext = extend_luts(w[:, list(cols)], logf)

    def dev(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)

    return DeviceTables(dev(gps), dev(gp0), dev(w_ext), dev(logf_ext), expand)


@dataclass
class ExactTables:
    """The port's exact-mode device tables for one wire config."""

    g_table: torch.Tensor  # (3V+3, NS+1) f64: gps (j, l) rows, gp0, neutral
    lut: torch.Tensor  # (R, C) f64 log LUT of the unique channels, none row
    expand: tuple  # A*9 logical mixture channels -> columns of lut
    gsel: tuple  # the 3 singlet (GL) channels -> columns of lut
    cmask: tuple  # C bools: the columns some mixture channel uses


def exact_tables_from_numpy(gps, grid_alpha, cap_bq, wire_cfg, device):
    """Exact-mode device tables from the numpy inputs the JAX engine takes
    (``_exact_tables`` :503 and ``pallas_pair_exact.split_tables`` :1166),
    in the log domain and f64:

    * the g table: f64 gps as (j, l) rows, the three host gp0 rows, and a
      neutral column at index NS ((1, 0, 0) for every sample and gp0) for
      masked slots, channel-leading for the kernels' gather;
    * the log LUT: the A*9 pair columns and the 3 singlet columns of
      ``ops/luts.py`` with a 0.0 none row last, rows cut to the run's code
      dictionary under a wire-v2 config, and the columns whose
      probabilities are byte-equal merged, exactly as ``split_tables``
      dedups them (so ``expand``, ``gsel`` and ``cmask`` equal its meta and
      the mixture-channel mask of ``demux_block_exact_impl`` :1275-1278)."""
    gps = _pad_gps(gps)
    gp0 = compute_gp0(gps)
    w = luts.pair_lut(list(grid_alpha), cap_bq)
    logf = luts.singlet_lut(cap_bq)
    nw = w.shape[1]
    logc = np.zeros((w.shape[0] + 1, nw + 3), dtype=np.float64)
    logc[:-1, :nw] = w
    logc[:-1, nw:] = logf
    allc = np.ones_like(logc)  # split_tables' probability table
    allc[:-1, :nw] = np.exp(w)
    allc[:-1, nw:] = np.exp(logf)
    if wire_cfg is not None:
        rows = list(wire_cfg.dict_codes) + [w.shape[0]]
        logc, allc = logc[rows], allc[rows]
    seen, cols, inv = {}, [], []
    for j in range(allc.shape[1]):
        key = allc[:, j].tobytes()
        if key not in seen:
            seen[key] = len(cols)
            cols.append(j)
        inv.append(seen[key])
    expand, gsel = tuple(inv[:nw]), tuple(inv[nw:])
    used = set(expand)
    cmask = tuple(c in used for c in range(len(cols)))
    ns, nv = gps.shape[:2]
    g = np.zeros((ns + 1, 3 * nv + 3), dtype=np.float64)
    g[:ns, : 3 * nv] = gps.reshape(ns, 3 * nv)
    g[:ns, 3 * nv :] = gp0
    g[ns, 0 : 3 * nv + 3 : 3] = 1.0
    return ExactTables(
        torch.as_tensor(np.ascontiguousarray(g.T), device=device),
        torch.as_tensor(np.ascontiguousarray(logc[:, cols]), device=device),
        expand, gsel, cmask,
    )


def _h2d(x, device):
    """numpy -> device tensor: pinned host copy + non_blocking H2D on CUDA
    (the caching host allocator keeps the pinned buffer alive until the
    copy is done); a plain wrap on the CPU."""
    if isinstance(x, (tuple, list)):
        return tuple(_h2d(e, device) for e in x)
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def _nbytes(*bufs):
    return sum(
        e.nbytes
        for buf in bufs
        if buf is not None
        for e in (buf if isinstance(buf, tuple) else (buf,))
    )


class DemuxEngine:
    def __init__(
        self,
        gps: np.ndarray,  # (nsnps, nv, 3) float64
        grid_alpha: Sequence[float],
        cap_bq: int = 40,
        cell_block: int = 256,
        mode: str = "exact",
        device: Optional[torch.device] = None,
    ):
        """mode="exact" (the JAX engine's default): f64 front and pair
        search with the singlet term (K2' and K3' on CUDA, K2', K7' and K6'
        when V*V*A > 384; their plain versions on the CPU), f64 decision
        pass. mode="fast": f32 pair search (K1), f32 singlet term, f64
        decision pass.
        device: a torch.device; None resolves "auto" (CUDA or DemuxError,
        ``utils/device.resolve_device``)."""
        if mode not in MODES:
            raise DemuxError(f"--mode {mode} is not a mode of the engine "
                             f"(one of {', '.join(MODES)})")
        self.gps = _pad_gps(gps)
        self.gp0 = compute_gp0(self.gps)
        self.grid_alpha = list(grid_alpha)
        self.cap_bq = cap_bq
        self.cell_block = cell_block
        self.mode = mode
        self.nv = gps.shape[1]
        self.n_alpha = len(self.grid_alpha)
        if mode == "fast" and self.nv * self.nv * self.n_alpha > UNROLL_CAP:
            raise DemuxError(
                f"V*V*A = {self.nv * self.nv * self.n_alpha} > {UNROLL_CAP} "
                "in fast mode needs the tiled f32 pair kernels (K4/K5), not "
                "ported to PyTorch yet (ROADMAP queue 1, item 13b); exact "
                "mode (the default) runs it"
            )
        if self.cap_bq > 126:
            raise DemuxError(
                "--cap-BQ > 126 is not representable by the u8 observation "
                "codes; exact mode takes it through the dense f64 run(), "
                "not ported to PyTorch yet (ROADMAP queue 1, item 12)"
            )
        if device is None:
            from demuxlet_tpu_torch.utils.device import resolve_device

            device = resolve_device("auto")
        self.device = device
        self._tables = None
        self._tables_v2 = None
        self._exact = None
        self._exact_v2 = None
        # wire v2 (host/wire.py): per-run packed H2D format, chosen once
        # per pileup; the (S, U) meta registry keeps same-shape blocks on
        # one layout
        self._wire_cfg = None
        self._wire_reg = {}
        self._wire_reg_lock = threading.Lock()

    def _sym_a(self):
        """Index of alpha == 0.5 in the grid (the (j,k)-symmetric doublet
        plane the kernels mirror instead of recomputing), if present."""
        return (self.grid_alpha.index(0.5)
                if 0.5 in self.grid_alpha else None)

    def _wire_cfg_for(self, scl):
        """The run's wire-v2 config, or None when the packed wire does
        not apply (cap-BQ > 126 breaks the u8 code bytes; dict-based
        pileups lack the CSR arrays). Cached per pileup; recomputing
        invalidates the dict LUT caches. DEMUX_TPU_WIRE=v1 forces the
        round-4 format."""
        if (
            self.cap_bq > 126
            or not hasattr(scl, "cell_ptr")
            or os.environ.get("DEMUX_TPU_WIRE", "v2") == "v1"
        ):
            return None
        # u16 fix/tail positions bound the slot axis: if ANY block could
        # pad past 65535 slots, disable v2 for the whole RUN (uniform
        # wire form)
        if hasattr(scl, "n_snps_all"):
            smax = int(np.max(scl.n_snps_all(), initial=0))
            # conservative pow2 bucket: coverage-sorted blocking pads
            # slot axes to powers of two
            if _bucket(max(smax, 1), minimum=128) > 0xFFFF:
                return None
        # the cfg cache rides ON the pileup (an id(scl)-keyed engine
        # cache could serve a stale dictionary to a different pileup
        # allocated at a reused address)
        cache = getattr(scl, "_wire_cfg_cache", None)
        if cache is not None and cache[0] == self.cap_bq:
            cfg = cache[1]
        else:
            from demuxlet_tpu_torch.host.wire import choose_cfg

            cfg = choose_cfg(scl, self.cap_bq)
            try:
                scl._wire_cfg_cache = (self.cap_bq, cfg)
            except AttributeError:
                pass
        if cfg != self._wire_cfg:
            self._wire_cfg = cfg
            self._tables_v2 = None
            self._exact_v2 = None
            self._wire_reg = {}
        return self._wire_cfg

    def _prep_codes_blk(self, scl, cells, pad=None):
        """Host block prep for the wire path: native C single pass
        (native/prep.py) with the Python build_codes_block +
        _shrink_codes_blk fallback, then (default) the v2 repack
        (host/wire.py). cap-BQ > 126 keeps the explicit (codes, idx,
        msk)."""
        kw = {} if pad is None else {"pad_slots_to": pad}
        cfg = self._wire_cfg_for(scl)
        if self.cap_bq <= 126 and hasattr(scl, "cell_ptr"):
            from demuxlet_tpu_torch.native import prep as nprep

            if cfg is not None and nprep.available():
                out = self._pack_reg(lambda ff: nprep.pack_block_v2(
                    scl, cells, cfg, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, floors_for=ff, **kw,
                ))
                if out is not None:
                    buf, meta = out
                    return buf, meta, None
            elif cfg is None:
                blk = nprep.prep_block_shrunk(
                    scl, cells, cap_bq=self.cap_bq,
                    pad_cells_to=self.cell_block, **kw,
                ) if nprep.available() else None
                if blk is not None:
                    return blk
        codes_blk = build_codes_block(
            scl, cells, cap_bq=self.cap_bq,
            pad_cells_to=self.cell_block, **kw,
        )
        if cfg is not None:
            from demuxlet_tpu_torch.host import wire as W

            key = (codes_blk[0].shape[1], codes_blk[0].shape[2])
            out = self._pack_reg(
                lambda ff: W.pack_wire_block(*codes_blk, cfg,
                                             floors=ff(key)))
            if out is not None:
                buf, meta = out
                return buf, meta, None
            # v2 declined (slot extent beyond u16 addressing): v1 wire
        return self._shrink_codes_blk(codes_blk)

    def _pack_reg(self, pack_fn):
        """Pack through the shape registry: pack_fn receives a
        floors-lookup callable (key=(S, U) -> harmonized (U0, K2p, Kp)
        or None); afterwards the produced meta raises its key's maxima.
        Prefetch threads race benignly — a stale floor only costs one
        extra layout, never correctness."""

        def floors_for(key):
            with self._wire_reg_lock:
                return self._wire_reg.get(key)

        out = pack_fn(floors_for)
        if out is None:
            return None
        buf, meta = out
        key = (meta[1], meta[2])
        u0, k2p, kp = meta[3], meta[4], meta[5]
        with self._wire_reg_lock:
            cur = self._wire_reg.get(key)
            if cur is None:
                self._wire_reg[key] = (u0, k2p, kp)
            else:
                self._wire_reg[key] = (
                    cur[0], max(cur[1], k2p), max(cur[2], kp))
        return buf, meta

    def _shrink_codes_blk(self, codes_blk):
        """Shrink the explicit (codes, idx, msk) block: msk is dropped (the
        device derives it from codes != 255; valid slots without codes
        carry the marker 254 in lane 0), and slot ids ship as u8 deltas
        with a sparse fix list when they can, else as 16-bit pairs packed
        into int32 lanes."""
        if self.cap_bq > 126:
            return codes_blk
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
                    [np.arange(n) for n in n_over]
                ).astype(np.int64) if K else np.zeros(0, np.int64)
                fix_pos[rows, slot] = cols.astype(np.int32)
                fix_val[rows, slot] = (d[rows, cols] - 255).astype(np.int32)
            d8 = np.minimum(d, 255).astype(np.uint8)
            base = idx[:, 0].astype(np.int32)
            return codes, (d8, base, fix_pos, fix_val), None
        if self.gps.shape[0] <= 0xFFFF and S % 2 == 0:
            u = idx.astype(np.uint32)
            idx = (u[:, 0::2] | (u[:, 1::2] << 16)).view(np.int32)
        return codes, idx, None

    def _fast_tables(self, cfg=None) -> DeviceTables:
        """Device tables for the run (cached per wire config)."""
        if cfg is not None:
            if self._tables_v2 is None:
                self._tables_v2 = tables_from_numpy(
                    self.gps, self.grid_alpha, self.cap_bq, cfg, self.device)
            return self._tables_v2
        if self._tables is None:
            self._tables = tables_from_numpy(
                self.gps, self.grid_alpha, self.cap_bq, None, self.device)
        return self._tables

    def _exact_tables(self, cfg=None) -> ExactTables:
        """Exact-mode device tables for the run (cached per wire config)."""
        if cfg is not None:
            if self._exact_v2 is None:
                self._exact_v2 = exact_tables_from_numpy(
                    self.gps, self.grid_alpha, self.cap_bq, cfg, self.device)
            return self._exact_v2
        if self._exact is None:
            self._exact = exact_tables_from_numpy(
                self.gps, self.grid_alpha, self.cap_bq, None, self.device)
        return self._exact

    def _blocks(self, n: int, scl=None):
        """Cell-id blocks, COVERAGE-SORTED (ascending distinct-SNP count,
        then depth) when it pays: each block pads its slot axis to the
        block max covered-SNP count, so grouping similar cells shrinks
        padded slots. Returns (blocks, pads): pads is None for natural
        order, else a per-block power-of-two slot pad (>= 128). Sorting
        engages on a >10% padded-slot saving; outputs are inverse-
        permuted after the run."""
        ids = np.arange(n, dtype=np.int64)
        if n and scl is not None and hasattr(scl, "n_snps_all"):
            counts = np.asarray(scl.n_snps_all())
            depth = (np.diff(np.asarray(scl.cell_ptr))
                     if hasattr(scl, "cell_ptr") else np.zeros_like(counts))
            order = ids[np.lexsort((depth, counts))]

            def block_maxes(perm):
                c = counts[perm]
                pad = (-len(c)) % self.cell_block
                if pad:
                    c = np.concatenate([c, np.zeros(pad, c.dtype)])
                return c.reshape(-1, self.cell_block).max(axis=1)

            cost_nat = int(
                np.maximum(-(-block_maxes(ids) // 128) * 128, 128).sum()
            )
            pow2 = [_bucket(max(int(m), 1), minimum=128)
                    for m in block_maxes(order)]
            if sum(pow2) < 0.9 * cost_nat:
                return [
                    order[s : s + self.cell_block].tolist()
                    for s in range(0, n, self.cell_block)
                ], pow2
        return [
            ids[s : s + self.cell_block].tolist()
            for s in range(0, n, self.cell_block)
        ], None

    def run_compact(self, scl, doublet_prior: float):
        """Exact- or fast-mode pipeline with the device-side decision pass
        (one block step per block: K2' + K3' in exact mode, K2' + K7' +
        K6' on pools with V*V*A > 384, K1 in fast mode): returns
        (llks, llk0s, decision.CompactResult). Per-run accounting:
        ``h2d_bytes`` (block buffers shipped) and ``phase_s`` (setup = wire
        config, tables and blocking, on the first call for a pileup also
        its one pass over all observations; prep = host packing on the
        prefetch pool, summed over threads; prep_wait = main-thread stall
        on prep; dispatch = H2D + enqueue; fetch = the one readback, which
        waits for the device, + unpacking)."""
        t_setup = time.monotonic()
        if not hasattr(scl, "cell_ptr"):
            scl = CsrPileup.from_pileup(scl)
        cfg = self._wire_cfg_for(scl)
        exact = self.mode == "exact"
        tab = self._exact_tables(cfg) if exact else self._fast_tables(cfg)
        dev = self.device
        dbl_w = torch.as_tensor(
            D.doublet_weights(self.nv, self.grid_alpha, doublet_prior),
            dtype=torch.float64, device=dev)
        dbl_msk = torch.as_tensor(D.doublet_mask(self.nv, self.n_alpha),
                                  device=dev)
        a0_sep = self.grid_alpha[0] == 0.0
        sym_a = self._sym_a()

        n = scl.nbcs
        llks = np.zeros((n, self.nv), dtype=np.float64)
        llk0s = np.zeros(n, dtype=np.float64)
        self.h2d_bytes = 0
        self.phase_s = {"setup": 0.0, "prep": 0.0, "prep_wait": 0.0,
                        "dispatch": 0.0, "fetch": 0.0}
        prep_lock = threading.Lock()

        blocks, pads = self._blocks(n, scl)
        jobs = list(zip(blocks, pads or [None] * len(blocks)))
        self.phase_s["setup"] = time.monotonic() - t_setup

        def prep(job):
            cells, pad = job
            t0 = time.monotonic()
            out = cells, self._prep_codes_blk(scl, cells, pad)
            with prep_lock:
                self.phase_s["prep"] += time.monotonic() - t0
            return out

        def dispatch(codes, idx, msk):
            wire = None
            if msk is None and isinstance(idx, tuple) and isinstance(idx[0], str):
                wire, idx = idx, None  # v2 packed wire: codes IS the buffer
            elif msk is None and isinstance(idx, tuple):
                codes, wire = _to_wire(codes, idx)
                idx = None
            # with a v2 cfg active the run's LUTs are the dict-narrowed
            # tables: a v1-form block would be scored against the wrong
            # rows. _wire_cfg_for's run-level gate makes mixing
            # unreachable; fail loudly if it ever is not.
            if cfg is not None and (wire is None or wire[0] != "w2"):
                raise RuntimeError("v1-form block in a wire-v2 run")
            self.h2d_bytes += _nbytes(codes, idx, msk)
            blk = (_h2d(codes, dev),
                   None if idx is None else _h2d(idx, dev),
                   None if msk is None else _h2d(msk, dev))
            if exact:
                return D.compact_step_body_exact(
                    *blk, tab, dbl_w, dbl_msk, self.n_alpha, self.nv,
                    doublet_prior, a0_sep=a0_sep, sym_a=sym_a, wire=wire,
                )
            return D.compact_step_body(
                *blk, tab.gps, tab.gp0, tab.w_ext, tab.logf_ext, dbl_w,
                dbl_msk, self.n_alpha, self.nv, doublet_prior, a0_sep=a0_sep,
                sym_a=sym_a, expand=tab.expand, wire=wire,
            )

        # defer all device->host readback to ONE transfer at the end
        dev_parts = []
        with ThreadPoolExecutor(max_workers=4) as prep_pool:
            it = _prefetched(prep_pool, prep, jobs)
            while True:
                t0 = time.monotonic()
                try:
                    cells, (codes, idx, msk) = next(it)
                except StopIteration:
                    break
                self.phase_s["prep_wait"] += time.monotonic() - t0
                t0 = time.monotonic()
                dev_parts.append((cells, dispatch(codes, idx, msk)))
                self.phase_s["dispatch"] += time.monotonic() - t0
        parts = []
        if dev_parts:
            t0 = time.monotonic()
            host = torch.cat([p for _, p in dev_parts], dim=0).cpu().numpy()
            off = 0
            for cells, p in dev_parts:
                m = len(cells)
                a, b, c = D.unpack_block(host[off : off + m], self.nv,
                                         self.n_alpha)
                llks[cells] = a
                llk0s[cells] = b
                parts.append(c)
                off += p.shape[0]
            self.phase_s["fetch"] += time.monotonic() - t0
        else:  # zero cells: empty fields of the right shapes
            width = 2 * self.nv + self.n_alpha + 11
            parts.append(D.unpack_block(np.zeros((0, width)), self.nv,
                                        self.n_alpha)[2])
        comp = D.concat(parts)
        perm = np.concatenate(
            [np.asarray(b, np.int64) for b in blocks]
        ) if blocks else np.zeros(0, np.int64)
        if not np.array_equal(perm, np.arange(n)):
            inv = np.empty(n, np.int64)
            inv[perm] = np.arange(n)
            comp = D.take(comp, inv)
        return llks, llk0s, comp


def cell_stats(scl: PileupData) -> CellStats:
    if hasattr(scl, "n_snps_all"):  # CSR form: vectorized distinct counts
        nsnp = scl.n_snps_all()
    else:
        nsnp = np.asarray(
            [scl.n_cell_snps(c) for c in range(scl.nbcs)], np.int64
        )
    return CellStats(
        barcodes=list(scl.barcodes),
        totl=np.asarray(scl.cell_totl, dtype=np.int64),
        pass_=np.asarray(scl.cell_pass, dtype=np.int64),
        uniq=np.asarray(scl.cell_uniq, dtype=np.int64),
        nsnp=nsnp,
    )
