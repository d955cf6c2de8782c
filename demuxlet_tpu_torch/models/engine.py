"""Demux engine on PyTorch (port of ``demuxlet_tpu/models/engine.py``,
exact and fast modes, one device or a mesh of them).

``run_compact`` follows the JAX engine's single-device branch: host
block prep on a prefetch pool (``models/blocks.py``: the run's block
format, wire v2 where it applies, packed natively or in numpy),
pinned-host H2D with ``non_blocking`` copies, the device decode
(``ops/wire.decode``) and the fused block step
(``decision.compact_step_body_exact`` in exact mode,
``decision.compact_step_body`` in fast mode) enqueued on the device, ONE
device-side concat and ONE readback at the end, then the inverse of the
coverage-sorted block permutation.

``run`` follows the JAX engine's full-tensor ``run()``: the same blocks
and host prep, the full (llk, llk0, llk_ab, llk_00) of each block copied
back on a worker thread (and spooled to a directory for resume), stored
by cell id. It takes the kernel route of ``run_compact``, or, in exact
mode when the user asks for ``exact_kernel="xla"``, f32 or cap-BQ > 126
(which the u8 codes cannot hold), the dense route: ``host/slots.py``
count slots through ``ops/likelihood.py``, as the JAX engine routes its
XLA path. Fast mode refuses cap-BQ > 126, as the JAX engine does.

The JAX module imports JAX at the top, so its JAX-free helpers are
copied: here ``compute_gp0``, ``_prefetched``, ``EngineResult``,
``_pad_block``, ``_blocks`` and ``cell_stats``, and those of the block
format in ``models/blocks.py``; tests/test_torch_engine.py pins each copy
to the original.

Both modes run every pool size: V*V*A > 384 takes the tiled K7' + K6'
(exact) or K5' + K4' (fast; ``ops/pair_tiled.py``) where smaller pools
take K3' or K1.

Under a mesh (``parallel/mesh.py``, the JAX engine's ``mesh``) block i
runs on mesh row i mod n_b: the kernel route on the row's first member,
the dense route split on the slot axis over the row's members. Each
member has its own tables, placed from one host build per wire config;
``run_compact`` reads each row's packed rows back in one transfer,
``run`` copies each block back on its member's stream. Results equal
the single-device run's, bit for bit (the slot split of the dense route
adds partial sums: within 1e-9).
"""

from __future__ import annotations

import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from demuxlet_tpu_torch.host.csr import CsrPileup
from demuxlet_tpu_torch.host.pileup import PileupData
from demuxlet_tpu_torch.host.slots import SlotBlock, build_slots
from demuxlet_tpu_torch.models.outputs import CellStats
from demuxlet_tpu_torch.ops import luts
from demuxlet_tpu_torch.utils.logging_utils import DemuxError
from demuxlet_tpu_torch.models import decision as D
from demuxlet_tpu_torch.models.blocks import BlockPacker, _bucket
from demuxlet_tpu_torch.ops.front import (
    fast_front,
    fast_g_table,
    front_entries,
)
from demuxlet_tpu_torch.ops.front_exact import exact_block
from demuxlet_tpu_torch.ops.pair import dedup_channels, extend_luts
from demuxlet_tpu_torch.ops.pair_exact import takes_k3
from demuxlet_tpu_torch.ops.pair_tiled import plan_tiles
from demuxlet_tpu_torch.ops.wire import decode
from demuxlet_tpu_torch.parallel import mesh as pmesh
from demuxlet_tpu_torch.utils.spans import span

MODES = ("exact", "fast")
EXACT_KERNELS = ("auto", "pallas", "xla")
# a run's phase_s keys, each the summed seconds of its span (utils/spans):
# set-up and the parts the benchmark reads, prep (thread-summed),
# prep_wait, dispatch, its block step's front (dispatch.front) and what
# follows the front (dispatch.pair), and fetch; the other spans are on the
# trace only
PHASES = ("setup", "setup.nsnp", "setup.wire_cfg", "setup.tables", "prep",
          "prep_wait", "dispatch", "dispatch.front", "dispatch.pair",
          "fetch")


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
    `pool` — overlaps host block prep (``models/blocks``: the native
    packer, whose calls release the GIL, with Python around them) with
    device compute; the serial prep was the end-to-end bottleneck at 100K
    cells."""
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


@dataclass
class EngineResult:
    llks: np.ndarray  # (ncells, nv)
    llk0s: np.ndarray  # (ncells,)
    llk_ab: np.ndarray  # (ncells, nv, nv, nA)
    llk_00: np.ndarray  # (ncells, nA)


@dataclass
class DeviceTables:
    """The port's device tables for one wire config."""

    gps: torch.Tensor  # (NS, V, 3) f32
    gp0: torch.Tensor  # (NS, 3) f32
    w_ext: torch.Tensor  # (R, C) f32 deduplicated pair LUT + none row
    logf_ext: torch.Tensor  # (R, 3) f32 singlet LUT + none row
    expand: tuple  # A*9 logical channels -> rows of the deduplicated LUT
    g_table: torch.Tensor  # (3V+3, NS+1) f32: ops/front.fast_g_table


def _pad_gps(gps: np.ndarray) -> np.ndarray:
    """Zero SNPs (e.g. a genome shard without markers) get one neutral row
    so gathers stay well-formed; every slot is then masked."""
    gps = np.ascontiguousarray(gps, dtype=np.float64)
    if gps.shape[0] == 0:
        gps = np.full((1, gps.shape[1], 3), 1.0 / 3)
    return gps


def host_tables(gps, grid_alpha, cap_bq, wire_cfg) -> DeviceTables:
    """The fast-mode tables on the host (CPU tensors), from the numpy
    inputs the JAX engine takes (``DemuxEngine.__init__`` :124-145 and
    ``_fast_tables`` :429): f32 gps and gp0, and the pair/singlet LUTs
    (``ops/luts.py``) with the A*9 columns deduplicated and, under a
    wire-v2 config, the rows cut to the run's code dictionary. ``place``
    puts them on a device."""
    gps = _pad_gps(gps)
    gp0 = compute_gp0(gps)
    logf = luts.singlet_lut(cap_bq)
    w = luts.pair_lut(list(grid_alpha), cap_bq)
    cols, expand = dedup_channels(list(grid_alpha))
    if wire_cfg is not None:
        rows = list(wire_cfg.dict_codes)
        w, logf = w[rows], logf[rows]
    w_ext, logf_ext = extend_luts(w[:, list(cols)], logf)

    def f32(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float32))

    gps_h, gp0_h = f32(gps), f32(gp0)
    return DeviceTables(gps_h, gp0_h, f32(w_ext), f32(logf_ext), expand,
                        fast_g_table(gps_h, gp0_h))


def place(tables, device):
    """A host table set (``host_tables``, ``exact_host_tables``) on
    ``device``: each tensor copied there, bit for bit; the same tensors on
    the CPU."""
    return dataclasses.replace(tables, **{
        f.name: getattr(tables, f.name).to(device)
        for f in dataclasses.fields(tables)
        if isinstance(getattr(tables, f.name), torch.Tensor)})


@dataclass
class ExactTables:
    """The port's exact-mode device tables for one wire config."""

    g_table: torch.Tensor  # (3V+3, NS+1) f64: gps (j, l) rows, gp0, neutral
    lut: torch.Tensor  # (R, C) f64 log LUT of the unique channels, none row
    expand: tuple  # A*9 logical mixture channels -> columns of lut
    gsel: tuple  # the 3 singlet (GL) channels -> columns of lut
    cmask: tuple  # C bools: the columns some mixture channel uses


def exact_host_tables(gps, grid_alpha, cap_bq, wire_cfg) -> ExactTables:
    """Exact-mode tables on the host (CPU tensors; ``place`` puts them on
    a device) from the numpy inputs the JAX engine takes
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
    return ExactTables(
        torch.as_tensor(_g_table(gps)),
        torch.as_tensor(np.ascontiguousarray(logc[:, cols])),
        expand, gsel, cmask,
    )


# SNPs a step of ``_g_table``'s transpose: a step's (rows, 3V) gps stay in
# the core's cache while they are written out as 3V row pieces
_G_ROWS = 256


def _g_table(gps: np.ndarray) -> np.ndarray:
    """The (3V+3, NS+1) f64 g table of ``exact_host_tables`` from padded
    gps (NS, V, 3), built channel-leading: the gps transposed a few hundred
    SNPs a step, then the gp0 rows as ``compute_gp0`` sums them (in sample
    order, then / V: the same bits) over the table's contiguous rows. At
    V=64 and 50,000 SNPs the table is 78 MB, and a strided pass over the
    gps (``compute_gp0``'s, or a whole transpose) costs more than the rest
    of the build."""
    ns, nv = gps.shape[:2]
    g = np.empty((3 * nv + 3, ns + 1), dtype=np.float64)
    flat = gps.reshape(ns, 3 * nv)
    for s in range(0, ns, _G_ROWS):
        e = min(s + _G_ROWS, ns)
        g[: 3 * nv, s:e] = flat[s:e].T
    gp0 = g[3 * nv :, :ns]
    gp0[...] = 0.0
    for j in range(nv):
        gp0 += g[3 * j : 3 * j + 3, :ns]
    gp0 /= nv
    g[:, ns] = 0.0
    g[0 : 3 * nv + 3 : 3, ns] = 1.0
    return g


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


class DemuxEngine:
    @span("engine_init")
    def __init__(
        self,
        gps: np.ndarray,  # (nsnps, nv, 3) float64
        grid_alpha: Sequence[float],
        cap_bq: int = 40,
        cell_block: int = 256,
        slot_chunk: int = 512,
        dtype: torch.dtype = torch.float64,
        mode: str = "exact",
        exact_kernel: str = "auto",
        device: Optional[torch.device] = None,
        mesh: Optional[pmesh.Mesh] = None,
    ):
        """mode="exact" (the JAX engine's default): f64 front and pair
        search with the singlet term (K2' and K3' on CUDA, K2', K7' and K6'
        when V*V*A > 384; their plain versions on the CPU), f64 decision
        pass. mode="fast": f32 pair search (K1, or K5' and K4' when
        V*V*A > 384; their plain versions on the CPU), f32 singlet term,
        decision pass in ``dtype``.
        exact_kernel: "auto" and "pallas" select the port's kernels; "xla"
        the dense route (``ops/likelihood.py``, the JAX package's XLA
        path), which exact mode also takes in f32 and at cap_bq > 126.
        slot_chunk: the dense route's slot chunk; dtype: torch.float64 or
        torch.float32.
        device: a torch.device; None resolves "auto" (CUDA or DemuxError,
        ``utils/device.resolve_device``).
        mesh: a ``parallel/mesh.Mesh`` (then ``device`` is its first
        member): blocks go to its rows in turn; a slot axis (n_s > 1)
        sends exact mode to the dense route and is refused in fast mode,
        as the JAX CLI refuses it."""
        if mode not in MODES:
            raise DemuxError(f"--mode {mode} is not a mode of the engine "
                             f"(one of {', '.join(MODES)})")
        if exact_kernel not in EXACT_KERNELS:
            raise DemuxError(f"--exact-kernel {exact_kernel} is not one of "
                             f"{', '.join(EXACT_KERNELS)}")
        if dtype not in (torch.float64, torch.float32):
            raise DemuxError(f"dtype {dtype} is neither float64 nor float32")
        if mode == "fast" and cap_bq > 126:
            raise DemuxError(
                "--cap-BQ > 126 is not representable by the fast-mode u8 "
                "observation codes; use --mode exact"
            )
        self.gps = _pad_gps(gps)
        self.grid_alpha = list(grid_alpha)
        self.cap_bq = cap_bq
        self.cell_block = cell_block
        self.slot_chunk = slot_chunk
        self.dtype = dtype
        self.mode = mode
        self.nv = gps.shape[1]
        self.n_alpha = len(self.grid_alpha)
        # the route (engine.py:172-191 of the JAX package): exact mode
        # leaves the kernels for the dense route only when asked, or when
        # the u8 codes cannot hold the qualities
        self.dense_reason = None
        if mode == "exact":
            if exact_kernel == "xla":
                self.dense_reason = "--exact-kernel xla"
            elif cap_bq > 126:
                self.dense_reason = (f"--cap-BQ {cap_bq} > 126, beyond the "
                                     "u8 observation codes")
            elif dtype == torch.float32:
                self.dense_reason = "--precision f32"
        if mesh is not None and mesh.shape["s"] > 1:
            shape = "%dx%d" % (mesh.shape["b"], mesh.shape["s"])
            if mode == "fast":
                raise DemuxError(f"--mesh {shape} with S > 1 requires --mode "
                                 "exact (slot-axis sum)")
            if self.dense_reason is None:
                # the slot-axis sum belongs to the dense route, as the
                # JAX engine's psum belongs to its XLA kernel
                self.dense_reason = f"--mesh {shape} slot axis"
        if mesh is not None:
            device = mesh.devices[0][0]
        elif device is None:
            from demuxlet_tpu_torch.utils.device import resolve_device

            device = resolve_device("auto")
        self.device = device
        self.mesh = mesh
        # the grid the blocks run on: the mesh, or this one device
        self._grid = mesh if mesh is not None else pmesh.Mesh(((device,),))
        self._dense_step = pmesh.build_sharded_step(
            self._grid, self.n_alpha, slot_chunk=slot_chunk, dtype=dtype)
        # host tables, built once per (kind, wire config) and counted
        # there; device tables, one set per (kind, mesh member), placed
        # from them for the wire config _cfg (``_tables``)
        self._host = {}
        self.host_table_builds = {}
        self._dev = {}
        self._cfg = None
        self.route = None  # set by each run: its kernels, or dense and why
        self._tile_items = 0  # set by each kernel-route run: _plan's items
        # the kernel route's block format, chosen once per pileup
        self._packer = BlockPacker(cap_bq, cell_block, self.gps.shape[0])
        self._reset_accounting()

    @functools.cached_property
    def gp0(self) -> np.ndarray:
        """(NS, 3) f64: ``compute_gp0`` of the gps, made on first use (the
        dense route's tables; the kernel route's tables build their own
        gp0 rows), so an engine of the kernel route never makes it."""
        return compute_gp0(self.gps)

    def _reset_accounting(self):
        """A run's accounting, zeroed at its start: ``h2d_bytes``,
        ``d2h_bytes``, ``phase_s`` (``PHASES``) and ``counts``, summed over
        the kernel route's blocks as shipped: their slots, padded cells
        times padded slots (slots_kernel); the tile items the tiled pair
        kernel K7' or K5' launches, a plan's items a block (pair_tile_items,
        0 on K3' and K1); the bytes of the (3V+3, B, S) g buffer the block
        step gathers from the g table (g_bytes); in fast mode the entries
        the front scatters into its count tables (front_entries,
        ``ops/front.front_entries``: dense lanes and tail entries, pads
        included; 0 in exact mode)."""
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.phase_s = dict.fromkeys(PHASES, 0.0)
        self.counts = dict(slots_kernel=0, pair_tile_items=0, g_bytes=0,
                           front_entries=0)

    def _sym_a(self):
        """Index of alpha == 0.5 in the grid (the (j,k)-symmetric doublet
        plane the kernels mirror instead of recomputing), if present."""
        return (self.grid_alpha.index(0.5)
                if 0.5 in self.grid_alpha else None)

    def _member(self, member):
        """The device of mesh member (row, s)."""
        return self._grid.devices[member[0]][member[1]]

    def _host_tables(self, kind, cfg=None):
        """The host build of one kind of tables ("fast", "exact" or
        "dense") for wire config cfg, made once and counted in
        ``host_table_builds``; every mesh member's tables are placed from
        it (the JAX engine's cached LUTs, which its mesh ``replicate``s)."""
        key = (kind, cfg)
        if key not in self._host:
            if kind == "dense":
                self._host[key] = tuple(
                    torch.as_tensor(x, dtype=self.dtype) for x in
                    (self.gps, self.gp0, luts.singlet_lut(self.cap_bq),
                     luts.pair_lut(self.grid_alpha, self.cap_bq)))
            else:
                build = host_tables if kind == "fast" else exact_host_tables
                self._host[key] = build(self.gps, self.grid_alpha,
                                        self.cap_bq, cfg)
            self.host_table_builds[key] = \
                self.host_table_builds.get(key, 0) + 1
        return self._host[key]

    def _tables(self, kind, member=(0, 0)):
        """The device tables of one kind on mesh member (row, s): "fast"
        (``DeviceTables``) and "exact" (``ExactTables``) for the wire
        config ``_cfg``, or "dense", the dense route's in the run's dtype
        (the JAX engine's ``_gps_dev``, ``_gp0_dev``, ``_logf_dev``,
        ``_w_dev``); placed from the host build and cached until the
        kernel route's format changes (``_kernel_setup``)."""
        key = (kind, member)
        if key not in self._dev:
            dev = self._member(member)
            if kind == "dense":
                self._dev[key] = tuple(
                    x.to(dev) for x in self._host_tables("dense"))
            else:
                self._dev[key] = place(self._host_tables(kind, self._cfg),
                                       dev)
        return self._dev[key]

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

    def _plan(self, tab):
        """The tile plan of the tiled pair kernel (K7' or K5') a
        kernel-route block step launches, or None on the unrolled one (K3'
        or K1), by the rules ``ops/pair_exact`` and ``ops/pair`` choose
        them with (``takes_k3``, ``unrolled``)."""
        V, A = self.nv, self.n_alpha
        a0_sep = self.grid_alpha[0] == 0.0
        if self.mode == "exact":
            if takes_k3(V, A, tab.lut.shape[1], a0_sep):
                return None
            # force: the few pools K3''s stages refuse at V*V*A <= 384
            return plan_tiles(V, A, a0_sep, self._sym_a(), force=True)
        return plan_tiles(V, A, a0_sep, self._sym_a())

    def _kernel_route(self, tab) -> str:
        """The kernels a kernel-route block step launches (``_plan``); sets
        the tile items a block's tiled pair kernel launches."""
        plan = self._plan(tab)
        self._tile_items = len(plan.items) if plan is not None else 0
        if self.mode == "exact":
            names = "K2' + K3'" if plan is None else "K2' + K7' + K6'"
        else:
            names = "K1" if plan is None else "K5' + K4'"
        where = ("CUDA" if self.device.type == "cuda"
                 else "their plain versions on the CPU")
        return f"kernels {names} ({where}){self._on_mesh()}"

    def _on_mesh(self) -> str:
        """The route's mesh suffix: "" on one device."""
        if self.mesh is None:
            return ""
        return " on a %dx%d mesh" % (self.mesh.shape["b"],
                                     self.mesh.shape["s"])

    def _ship(self, blk, tab, dev):
        """A packed block (``blocks.Block``) to device dev, whose tables
        tab are: its buffers copied there as they are; counts
        ``h2d_bytes`` and the block's ``counts``, and is the span
        dispatch.h2d."""
        with span("dispatch.h2d"):
            slots = blk.bufs[0].shape[0] * blk.meta[1]
            self.h2d_bytes += sum(b.nbytes for b in blk.bufs)
            self.counts["slots_kernel"] += slots
            self.counts["pair_tile_items"] += self._tile_items
            self.counts["g_bytes"] += (tab.g_table.shape[0] * slots
                                       * tab.g_table.element_size())
            return _h2d(blk.bufs, dev)

    def _dispatch(self, row, blk, decide=None):
        """One packed block through the kernel route on mesh row row's
        first member: shipped (``_ship``), decoded (``ops/wire.decode``)
        and through the mode's block step with the member's tables. Without
        decide (``run``), returns (llk (B, V), llk0 (B,), llk_ab (B, V, V,
        A), llk_00 (B, A)) there, f64 in exact mode
        (``ops/front_exact.exact_block``), f32 in fast mode
        (``ops/front.fast_front``); with decide = (dbl_w, dbl_msk,
        doublet_prior), the first two on that device (``run_compact``),
        the packed decision rows (``decision.compact_step_body_exact`` or
        ``compact_step_body``, looked up at the call)."""
        member = (row, 0)
        tab = self._tables(self.mode, member)
        bufs = self._ship(blk, tab, self._member(member))
        args = (tab, self.n_alpha, self.nv, *(decide or ()))
        kw = dict(a0_sep=self.grid_alpha[0] == 0.0, sym_a=self._sym_a(),
                  acct=self.phase_s)
        if self.mode == "exact":
            step = (exact_block if decide is None
                    else D.compact_step_body_exact)
        elif decide is None:
            step = fast_front
        else:
            step, kw["dtype"] = D.compact_step_body, self.dtype
        # decoded in the call, so that the step lets the decoded lanes go
        # after its front
        return step(self._decoded(bufs, blk.meta), *args, **kw)

    def _decoded(self, bufs, meta):
        """A shipped block decoded (``ops/wire.decode``); in fast mode its
        front's scatter entries added to ``counts["front_entries"]``."""
        parts = decode(bufs, meta)
        if self.mode == "fast":
            self.counts["front_entries"] += front_entries(parts)
        return parts

    def _run_block(self, blk: SlotBlock, row: int = 0):
        """One ``build_slots`` block through the dense route on mesh row
        ``row`` (``ops/likelihood.py``; the JAX engine's ``_run_block``):
        the slot axis in one contiguous part per member of the row, each
        shipped to its member, which takes the gps and gp0 rows by idx and
        computes the singlet and pair LLKs in the run's dtype; the row's
        first member adds the parts (``parallel/mesh.build_sharded_step``).
        Returns (llk, llk0, llk_ab, llk_00) on that member."""
        members = self._grid.devices[row]
        with span("dispatch.h2d"):
            self.h2d_bytes += blk.idx.nbytes + blk.msk.nbytes + blk.cnt.nbytes
            self.counts["slots_kernel"] += blk.idx.shape[0] * blk.idx.shape[1]
            parts = [_h2d(p, dev) for p, dev in zip(
                pmesh.split_slots(len(members), blk.idx, blk.msk, blk.cnt),
                members)]
        tables = [self._tables("dense", (row, s))
                  for s in range(len(members))]
        return self._dense_step(row, parts, tables)

    def run_compact(self, scl, doublet_prior: float):
        """Exact- or fast-mode pipeline with the device-side decision pass
        (one block step per block: K2' + K3' in exact mode, K2' + K7' +
        K6' on pools with V*V*A > 384; K1 in fast mode, K5' + K4' on
        those pools): returns
        (llks, llk0s, decision.CompactResult). Per-run accounting:
        ``h2d_bytes`` (block buffers shipped), ``d2h_bytes`` (the packed
        rows read back), ``counts`` (the slots shipped) and ``phase_s``,
        each key a span (``utils/spans``): setup = block format, tables
        and blocking (``_kernel_setup``), on the first call for a pileup
        also its passes over all observations (setup.nsnp, setup.wire_cfg;
        then setup.tables and the trace's setup.blocks; the doublet
        weights' upload is setup's own time); prep = host packing
        (``blocks.BlockPacker.pack``) on the prefetch pool, summed over
        threads; prep_wait = main-thread stall on prep; dispatch = H2D
        (the trace's dispatch.h2d) + enqueue; fetch = the one readback,
        which waits for the device (fetch.readback), + unpacking
        (fetch.unpack). The trace's finish is the concatenation and the
        inverse permutation. Fast mode
        decides in the engine's dtype (f32 is the JAX CLI's
        ``--precision f32``); the dense route has no compact step (use
        ``run``)."""
        if self.dense_reason is not None:
            raise DemuxError("run_compact takes the kernel route; this "
                             f"engine takes the dense route "
                             f"({self.dense_reason}): use run()")
        self._reset_accounting()
        acct = self.phase_s
        with span("setup", acct):
            scl, cfg = self._kernel_setup(scl, acct)
            rows = self._grid.shape["b"]
            dbl_w = D.doublet_weights(self.nv, self.grid_alpha, doublet_prior)
            dbl_msk = D.doublet_mask(self.nv, self.n_alpha)
            dtype = torch.float64 if self.mode == "exact" else self.dtype
            decide = [
                (torch.as_tensor(dbl_w, device=dev, dtype=dtype),
                 torch.as_tensor(dbl_msk, device=dev), doublet_prior)
                for dev in (self._member((r, 0)) for r in range(rows))]

            n = scl.nbcs
            llks = np.zeros((n, self.nv), dtype=np.float64)
            llk0s = np.zeros(n, dtype=np.float64)
            jobs = self._setup_blocks(scl)

        # defer all device->host readback to ONE transfer per mesh row at
        # the end
        dev_parts = []

        def step(cells, blk, row):
            with span("dispatch", acct):
                dev_parts.append(
                    (cells, row, self._dispatch(row, blk, decide[row])))

        self._drive_blocks(
            jobs, lambda cells, pad: self._packer.pack(scl, cells, cfg, pad),
            step)
        parts = []
        if dev_parts:
            with span("fetch", acct):
                host = {}
                with span("fetch.readback"):
                    for r in range(rows):
                        mine = [p for _, row, p in dev_parts if row == r]
                        if mine:
                            host[r] = torch.cat(mine, dim=0).cpu().numpy()
                self.d2h_bytes = sum(h.nbytes for h in host.values())
                off = [0] * rows
                with span("fetch.unpack"):
                    for cells, r, p in dev_parts:
                        m = len(cells)
                        a, b, c = D.unpack_block(
                            host[r][off[r] : off[r] + m], self.nv,
                            self.n_alpha)
                        llks[cells] = a
                        llk0s[cells] = b
                        parts.append(c)
                        off[r] += p.shape[0]
        else:  # zero cells: empty fields of the right shapes
            width = 2 * self.nv + self.n_alpha + 11
            parts.append(D.unpack_block(np.zeros((0, width)), self.nv,
                                        self.n_alpha)[2])
        with span("finish"):
            comp = D.concat(parts)
            perm = np.concatenate(
                [np.asarray(b, np.int64) for b, _ in jobs]
            ) if jobs else np.zeros(0, np.int64)
            if not np.array_equal(perm, np.arange(n)):
                inv = np.empty(n, np.int64)
                inv[perm] = np.arange(n)
                comp = D.take(comp, inv)
        return llks, llk0s, comp

    def run(self, scl: PileupData,
            spool_dir: Optional[str] = None) -> EngineResult:
        """All barcode blocks with the full LLK tensors (the JAX engine's
        ``run()``): returns an ``EngineResult`` of f64 host arrays, stored
        by cell id (coverage-sorted blocks permute cells).

        Host prep (spool probe, wire pack or dense slots) runs on a
        4-thread prefetch pool; H2D and the enqueue on the calling thread,
        which never waits on the device before it dispatches the next
        block; each block's outputs are copied back into pinned host
        memory and a worker thread waits for the copy, writes the spool
        file and hands the arrays back, one block outstanding while the
        next is enqueued.

        spool_dir: per-block results for checkpoint/resume, one file a
        block, ``block_%08d_%d.npz`` of its first cell id and its length,
        with the keys a, b, c, d (llk, llk0, llk_ab, llk_00) and cells,
        the JAX engine's names and keys (so either package resumes the
        other's directory); a file is used only when its cells equal the
        block's, else the block is recomputed.

        Accounting as in ``run_compact``: ``h2d_bytes``, ``d2h_bytes``
        (outputs copied back), ``counts`` and ``phase_s`` (setup and its
        parts; prep, thread-summed; prep_wait; dispatch = H2D
        (dispatch.h2d) + enqueue + the copy's enqueue; fetch = the calling
        thread's waits for finished blocks (fetch.readback) and their
        stores (fetch.unpack), and a spooled block's store)."""
        self._reset_accounting()
        acct = self.phase_s
        with span("setup", acct):
            if spool_dir:
                os.makedirs(spool_dir, exist_ok=True)
            dense = self.dense_reason is not None
            cfg = None
            if dense:
                self.route = (f"dense ({self.dtype}; {self.dense_reason})"
                              f"{self._on_mesh()}")
            else:
                scl, cfg = self._kernel_setup(scl, acct)
            n, nv, na = scl.nbcs, self.nv, self.n_alpha
            llks = np.zeros((n, nv), dtype=np.float64)
            llk0s = np.zeros(n, dtype=np.float64)
            llk_ab = np.zeros((n, nv, nv, na), dtype=np.float64)
            llk_00 = np.zeros((n, na), dtype=np.float64)
            jobs = self._setup_blocks(scl)

        def spool_path(cells):
            return os.path.join(
                spool_dir, "block_%08d_%d.npz" % (cells[0], len(cells)))

        def prep(cells, pad):
            if spool_dir and os.path.exists(spool_path(cells)):
                with np.load(spool_path(cells)) as z:
                    # a file from another blocking must recompute, never
                    # misattribute
                    if "cells" in z.files and np.array_equal(
                            z["cells"], np.asarray(cells, np.int64)):
                        return "spooled", tuple(z[k] for k in "abcd")
            if dense:
                blk = build_slots(scl, cells, cap_bq=self.cap_bq)
                # a power of two of at least n_s slots splits evenly over
                # a mesh row's members
                return "slots", _pad_block(blk, self.cell_block, _bucket(
                    blk.idx.shape[1], max(8, self._grid.shape["s"])))
            return "codes", self._packer.pack(scl, cells, cfg, pad)

        def store(cells, arrs):
            m = len(cells)
            a, b, c, d = arrs
            llks[cells] = a[:m]
            llk0s[cells] = b[:m]
            llk_ab[cells] = c[:m]
            llk_00[cells] = d[:m]

        def start_d2h(outs, m):
            """Enqueue the copy of the block's m real cells on the stream
            of the device that holds them; returns what the worker waits
            on."""
            outs = [x[:m] for x in outs]
            self.d2h_bytes += sum(x.numel() * x.element_size() for x in outs)
            dev = outs[0].device
            if dev.type != "cuda":
                return outs, None
            host = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                    for x in outs]
            with torch.cuda.device(dev):
                for h, x in zip(host, outs):
                    h.copy_(x, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(dev))
            return host, done

        def finish(cells, copy):
            host, done = copy
            if done is not None:
                done.synchronize()
            arrs = tuple(x.numpy() for x in host)
            if spool_dir:
                # np.savez appends .npz to a name without it
                tmp = spool_path(cells) + ".tmp.npz"
                np.savez(tmp, a=arrs[0], b=arrs[1], c=arrs[2], d=arrs[3],
                         cells=np.asarray(cells, np.int64))
                os.replace(tmp, spool_path(cells))
            return arrs

        def collect(pending):
            cells, fut = pending
            with span("fetch", acct):
                with span("fetch.readback"):
                    arrs = fut.result()
                with span("fetch.unpack"):
                    store(cells, arrs)

        pending = []
        # two D2H workers: the outstanding block's and the one just enqueued
        with ThreadPoolExecutor(max_workers=2) as pool:

            def step(cells, prepped, row):
                kind, data = prepped
                if kind == "spooled":
                    with span("fetch", acct):
                        store(cells, data)
                    return
                with span("dispatch", acct):
                    if kind == "slots":
                        outs = self._run_block(data, row)
                    else:
                        outs = self._dispatch(row, data)
                    copy = start_d2h(outs, len(cells))
                    del outs
                pending.append((cells, pool.submit(finish, cells, copy)))
                if len(pending) > 1:
                    collect(pending.pop(0))

            self._drive_blocks(jobs, prep, step)
            for p in pending:
                collect(p)
        return EngineResult(llks, llk0s, llk_ab, llk_00)

    def _kernel_setup(self, scl, acct):
        """The kernel route's set-up of ``run`` and ``run_compact``: the
        pileup in CSR form; the run's block format
        (``blocks.BlockPacker.choose``, with its spans setup.nsnp and
        setup.wire_cfg: made here, else the 4 prep threads would each race
        through the config's pass over all observations); each mesh row's
        tables for it (setup.tables) and the route. A format other than
        the last run's drops the device tables, and a new wire config
        also the host tables of the one before. Returns (the CSR pileup,
        the wire config or None)."""
        if not hasattr(scl, "cell_ptr"):
            scl = CsrPileup.from_pileup(scl)
        cfg = self._packer.choose(scl, acct)
        if cfg != self._cfg:
            self._cfg = cfg
            self._dev = {}
            if cfg is not None:
                self._host = {k: t for k, t in self._host.items()
                              if k[1] in (None, cfg)}
        with span("setup.tables", acct):
            tabs = [self._tables(self.mode, (r, 0))
                    for r in range(self._grid.shape["b"])]
        self.route = self._kernel_route(tabs[0])
        return scl, cfg

    def _setup_blocks(self, scl):
        """The run's blocks as (cells, slot pad or None) jobs, the span
        setup.blocks (``_blocks``)."""
        with span("setup.blocks"):
            blocks, pads = self._blocks(scl.nbcs, scl)
        return list(zip(blocks, pads or [None] * len(blocks)))

    def _drive_blocks(self, jobs, prep_block, step):
        """The block loop of ``run`` and ``run_compact`` over ``jobs``
        (``_setup_blocks``): runs ``prep_block(cells, pad)`` on the
        4-thread prefetch pool, one span prep a block, and
        ``step(cells, prepped, row)`` on the calling thread in block
        order, block i on mesh row i mod n_b (row 0 on one device), after
        a span prep_wait; ``step`` spans its own dispatch and fetch."""
        acct = self.phase_s

        def prep(job):
            with span("prep", acct):
                return job[0], prep_block(*job)

        rows = self._grid.shape["b"]
        with ThreadPoolExecutor(max_workers=4) as prep_pool:
            it = _prefetched(prep_pool, prep, jobs)
            for i in range(len(jobs)):
                with span("prep_wait", acct):
                    cells, prepped = next(it)
                step(cells, prepped, i % rows)


def _pad_block(blk: SlotBlock, n_cells: int, n_slots: int) -> SlotBlock:
    B, S = blk.idx.shape
    if B == n_cells and S == n_slots:
        return blk
    pb, ps = n_cells - B, n_slots - S
    return SlotBlock(
        cell_ids=blk.cell_ids,
        idx=np.pad(blk.idx, ((0, pb), (0, ps))),
        msk=np.pad(blk.msk, ((0, pb), (0, ps))),
        cnt=np.pad(blk.cnt, ((0, pb), (0, ps), (0, 0))),
    )


@span("cell_stats")
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
