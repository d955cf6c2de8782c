"""Multi-process execution: distributed init, barcode and genome shards,
result merge (port of ``demuxlet_tpu/parallel/multihost.py``).

The reference scales across machines only by manual ``--group-list``
splits (cmd_cram_demuxlet.cpp:68). Here the same decomposition is
first-class:

  1. every process calls ``initialize()`` (``torch.distributed``) and
     learns its (rank, world size);
  2. each process ingests and demuxes only the barcodes of its stripe
     (``owns_barcode``), or only the SNPs of its genome shard;
  3. per-barcode rows merge to process 0 (``gather_compact``,
     ``gather_results``, ``gather_results_sum_compact``,
     ``gather_results_sum``), sorted by barcode to reproduce the
     reference's std::map output order (cmd_cram_demuxlet.cpp:472,576).

The JAX package runs two kinds of collective. Its gathers
(``mhu.process_allgather``) move host arrays; the genome-shard merge's
reduce-scatter (``lax.psum_scatter`` over a mesh of each process's lead
device) and the decision after it run on the devices. The port does the
same. The default process group is gloo's, and every gather moves host
(CPU) tensors over it. The reduce-scatter takes one of two routes, which
``initialize`` decides once from every process's merge key
(``merge_key``, ``merge_route``):

  * ``nccl``: every process drives a card and no two share one (by
    NCCL's own test: the host, or ``NCCL_HOSTID`` where it is set, and
    the card's UUID). The LLK chunks go to the card and are reduced over
    an NCCL group into device tensors, which the decision pass reads
    where they lie;
  * ``host``: any process on the CPU, or two on one card (which NCCL
    refuses). The chunks are reduced over gloo as host tensors, then
    copied to the device for the decision pass.

Nothing falls back: an NCCL error fails the run. The merges are pure
(arrays in, arrays out) and equal their one-process form: one process
merges its own shard.

``owns_barcode``, ``shard_filter``, ``ShardResult``, ``merge_shards``,
``CompactShard``, ``merge_compact_shards``, ``merge_shards_sum``,
``_COMPACT_F64`` and ``_COMPACT_I64`` are copies of the JAX module's
(tests/test_torch_multihost.py pins each one to the original);
``owns_barcode`` takes its stripe from the ingest's ``host/pileup._owns``,
so one Python function defines it.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from demuxlet_tpu_torch.host.pileup import _owns

# the most bytes of one chunk of gather_results_sum_compact's reduce-scatter
_MAX_CHUNK_BYTES = 48 << 20

# the joined group's reduce-scatter route: (route, NCCL group or None,
# the device the chunks are reduced on); set by initialize
_merge = ("host", None, torch.device("cpu"))


def merge_key(device: Optional[torch.device]) -> str:
    """This process's merge key: "cpu" unless ``device`` is a card; for a
    card, the host (``NCCL_HOSTID`` if set, else the hostname) and the
    card's UUID, the pair NCCL tells ranks' devices apart by."""
    if device is None or torch.device(device).type != "cuda":
        return "cpu"
    host = os.environ.get("NCCL_HOSTID") or socket.gethostname()
    return f"{host}/{torch.cuda.get_device_properties(device).uuid}"


def merge_route(keys: Sequence[str]) -> str:
    """The reduce-scatter's route from every process's ``merge_key``:
    "nccl" when every process drives a card and no two keys are equal,
    else "host"."""
    keys = list(keys)
    if "cpu" not in keys and len(set(keys)) == len(keys):
        return "nccl"
    return "host"


def initialize(
    coordinator_address: str, num_processes: int, process_id: int,
    device: Optional[torch.device] = None,
) -> tuple[int, int]:
    """Join the gloo process group at ``tcp://<coordinator_address>``
    (host:port) as process ``process_id`` of ``num_processes``, this
    process driving ``device`` (None: the CPU); then all-gather the merge
    keys and decide the reduce-scatter's route (``merge_route``), joining
    an NCCL group on every process when it is "nccl". Returns
    (process_id, n_processes)."""
    global _merge
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )
    keys = [None] * num_processes
    dist.all_gather_object(keys, merge_key(device))
    if merge_route(keys) == "nccl":
        _merge = ("nccl", dist.new_group(backend="nccl"),
                  torch.device(device))
    else:
        _merge = ("host", None, torch.device("cpu"))
    return process_index(), process_count()


def current_route() -> str:
    """The route ``initialize`` chose for the reduce-scatter: "nccl" or
    "host" ("host" outside a process group)."""
    return _merge[0]


def shutdown() -> None:
    """Leave the process group (and the NCCL group), if this process
    joined one."""
    global _merge
    if dist.is_initialized():
        dist.destroy_process_group()
    _merge = ("host", None, torch.device("cpu"))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def owns_barcode(barcode: str, shard_id: int, n_shards: int) -> bool:
    """Deterministic barcode -> shard assignment (stable across runs/hosts):
    the crc32 stripe that the Python ingest applies."""
    return n_shards <= 1 or _owns(barcode, shard_id, n_shards)


def shard_filter(shard_id: int, n_shards: int):
    """A group-set-style predicate for the ingest layer."""
    return lambda bc: owns_barcode(bc, shard_id, n_shards)


@dataclass
class ShardResult:
    """One shard's per-barcode outputs, ready to merge."""

    barcodes: List[str]
    totl: np.ndarray
    pass_: np.ndarray
    uniq: np.ndarray
    nsnp: np.ndarray
    llks: np.ndarray  # (n, nv)
    llk0s: np.ndarray  # (n,)
    llk_ab: np.ndarray  # (n, nv, nv, na)
    llk_00: np.ndarray  # (n, na)


def merge_shards(shards: Sequence[ShardResult]) -> ShardResult:
    """Concatenate shard rows and sort by barcode (reference output order).

    Barcodes must be disjoint across shards (they are, by owns_barcode)."""
    barcodes: List[str] = []
    for s in shards:
        barcodes.extend(s.barcodes)
    order = np.argsort(np.asarray(barcodes, dtype=object), kind="stable")
    cat = lambda f: np.concatenate([getattr(s, f) for s in shards])[order]
    return ShardResult(
        barcodes=[barcodes[i] for i in order],
        totl=cat("totl"),
        pass_=cat("pass_"),
        uniq=cat("uniq"),
        nsnp=cat("nsnp"),
        llks=cat("llks"),
        llk0s=cat("llk0s"),
        llk_ab=cat("llk_ab"),
        llk_00=cat("llk_00"),
    )


def _allgather(a: np.ndarray) -> np.ndarray:
    """Every process's array of one shape stacked: (P,) + a.shape (the JAX
    ``process_allgather``), one gloo all-gather of a host tensor."""
    t = torch.from_numpy(np.ascontiguousarray(a)).reshape(-1)
    out = torch.empty(process_count() * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(out, t)
    return out.numpy().reshape((process_count(),) + a.shape)


def _padded_gather(fields, counts):
    """Each field (n, ...) zero-padded to the largest shard's rows and
    all-gathered: a list of (P, nmax, ...) arrays."""
    nmax = int(max(counts.max(), 1))

    def pad(a):
        out = np.zeros((nmax,) + a.shape[1:], dtype=a.dtype)
        out[: len(a)] = a
        return out

    return [_allgather(pad(np.asarray(f))) for f in fields]


def _encode_barcodes(barcodes: Sequence[str]) -> np.ndarray:
    """Fixed-width byte matrix sized to the GLOBAL max barcode length
    (allgathered), so no barcode is ever truncated."""
    raws = [b.encode() for b in barcodes]
    local_max = max((len(r) for r in raws), default=0)
    width = int(_allgather(np.asarray([local_max], dtype=np.int64)).max())
    width = max(width, 1)
    bc = np.zeros((len(raws), width), dtype=np.uint8)
    for i, raw in enumerate(raws):
        bc[i, : len(raw)] = np.frombuffer(raw, dtype=np.uint8)
    return bc


def _decode_barcodes(rows) -> List[str]:
    return [bytes(row.astype(np.uint8)).rstrip(b"\x00").decode()
            for row in rows]


def _gather_full(local: ShardResult) -> Optional[List[ShardResult]]:
    """Every process's full shard (the (n, V, V, A) tensor included) on
    process 0, None elsewhere."""
    bc = _encode_barcodes(local.barcodes)
    counts = _allgather(np.asarray([len(local.barcodes)], dtype=np.int64))
    fields = [
        bc.astype(np.int32), local.totl, local.pass_, local.uniq, local.nsnp,
        local.llks, local.llk0s, local.llk_ab, local.llk_00,
    ]
    gathered = _padded_gather(fields, counts)
    if process_index() != 0:
        return None
    shards = []
    for p in range(process_count()):
        g = [arr[p][: int(counts[p])] for arr in gathered]
        shards.append(ShardResult(
            barcodes=_decode_barcodes(g[0]), totl=g[1], pass_=g[2],
            uniq=g[3], nsnp=g[4], llks=g[5], llk0s=g[6], llk_ab=g[7],
            llk_00=g[8],
        ))
    return shards


def gather_results(local: ShardResult) -> Optional[ShardResult]:
    """All-gather FULL shard results across processes; returns the merged
    result on process 0 and None elsewhere. Single-process: identity.

    Ships the whole (n,V,V,A) tensor -- needed only for --write-pair; the
    default distributed path is gather_compact (per-cell decision rows)."""
    if process_count() == 1:
        return merge_shards([local])
    shards = _gather_full(local)
    return None if shards is None else merge_shards(shards)


# ---------------------------------------------------------------- compact
@dataclass
class CompactShard:
    """One shard's per-barcode outputs in compact (decision-row) form:
    O(V + A) floats per cell instead of the (V,V,A) tensor -- what
    actually crosses between processes in the default distributed path."""

    barcodes: List[str]
    totl: np.ndarray
    pass_: np.ndarray
    uniq: np.ndarray
    nsnp: np.ndarray
    llks: np.ndarray  # (n, V) pass-1 singlet LLKs
    llk0s: np.ndarray  # (n,)
    compact: "object"  # models.decision.CompactResult


def merge_compact_shards(shards: Sequence[CompactShard]) -> CompactShard:
    """Concatenate shard rows and sort by barcode (reference output order,
    cmd_cram_demuxlet.cpp:472,576). Barcodes must be disjoint."""
    from demuxlet_tpu_torch.models.decision import CompactResult

    barcodes: List[str] = []
    for s in shards:
        barcodes.extend(s.barcodes)
    order = np.argsort(np.asarray(barcodes, dtype=object), kind="stable")
    cat = lambda f: np.concatenate([getattr(s, f) for s in shards])[order]
    ccat = lambda f: np.concatenate(
        [getattr(s.compact, f) for s in shards]
    )[order]
    compact = CompactResult(
        **{f: ccat(f) for f in CompactResult.__dataclass_fields__}
    )
    return CompactShard(
        barcodes=[barcodes[i] for i in order],
        totl=cat("totl"),
        pass_=cat("pass_"),
        uniq=cat("uniq"),
        nsnp=cat("nsnp"),
        llks=cat("llks"),
        llk0s=cat("llk0s"),
        compact=compact,
    )


_COMPACT_F64 = (
    "sing_col", "llk_00", "max_llk", "sum_single", "sum_double",
    "max_sing2", "pair_llk12", "pair_llk10", "pair_llk20",
)
_COMPACT_I64 = ("i_sing1", "i_sing2", "best_flat")


def gather_compact(local: CompactShard) -> Optional[CompactShard]:
    """All-gather compact decision rows across processes; merged result on
    process 0, None elsewhere. Three padded all-gathers (barcode bytes,
    one packed f64 matrix, one packed i64 matrix): ~(2V+A+12) values a
    cell."""
    if process_count() == 1:
        return merge_compact_shards([local])

    from demuxlet_tpu_torch.models.decision import CompactResult

    n = len(local.barcodes)
    V = local.llks.shape[1]
    A = local.compact.llk_00.shape[1]
    bc = _encode_barcodes(local.barcodes)

    fcols = [np.asarray(local.llks, np.float64).reshape(n, V),
             np.asarray(local.llk0s, np.float64).reshape(n, 1)]
    for f in _COMPACT_F64:
        a = np.asarray(getattr(local.compact, f), np.float64)
        fcols.append(a.reshape(n, -1))
    fmat = np.concatenate(fcols, axis=1) if n else np.zeros(
        (0, 2 * V + A + 8), np.float64
    )
    icols = [
        np.asarray(local.totl, np.int64), np.asarray(local.pass_, np.int64),
        np.asarray(local.uniq, np.int64), np.asarray(local.nsnp, np.int64),
    ] + [np.asarray(getattr(local.compact, f), np.int64) for f in _COMPACT_I64]
    imat = np.stack(icols, axis=1) if n else np.zeros((0, 7), np.int64)

    counts = _allgather(np.asarray([n], dtype=np.int64))
    g_bc, g_f, g_i = _padded_gather([bc, fmat, imat], counts)
    if process_index() != 0:
        return None

    shards = []
    for p in range(process_count()):
        np_ = int(counts[p])
        f = np.asarray(g_f[p][:np_], np.float64)
        ii = np.asarray(g_i[p][:np_], np.int64)
        o = 0
        llks = f[:, o : o + V]; o += V
        llk0s = f[:, o]; o += 1
        cvals = {}
        for name in _COMPACT_F64:
            w = {"sing_col": V, "llk_00": A}.get(name, 1)
            col = f[:, o : o + w]; o += w
            cvals[name] = col if w > 1 else col[:, 0]
        for k, name in enumerate(_COMPACT_I64):
            cvals[name] = ii[:, 4 + k]
        shards.append(CompactShard(
            barcodes=_decode_barcodes(g_bc[p][:np_]),
            totl=ii[:, 0], pass_=ii[:, 1], uniq=ii[:, 2], nsnp=ii[:, 3],
            llks=llks, llk0s=llk0s, compact=CompactResult(**cvals),
        ))
    return merge_compact_shards(shards)


# ---------------------------------------------------------- genome shards
def merge_shards_sum(shards: Sequence[ShardResult]) -> ShardResult:
    """Merge GENOME-sharded results: the same barcode appears in several
    shards with partial (disjoint-SNP) contributions, and log-likelihoods,
    read counters and SNP counts all SUM. Output rows sort by barcode
    (reference output order)."""
    order: List[str] = []
    index = {}
    for s in shards:
        for b in s.barcodes:
            if b not in index:
                index[b] = len(order)
                order.append(b)
    sorted_bcs = sorted(order)
    pos = {b: i for i, b in enumerate(sorted_bcs)}
    n = len(sorted_bcs)
    first = shards[0]
    out = ShardResult(
        barcodes=sorted_bcs,
        totl=np.zeros(n, first.totl.dtype),
        pass_=np.zeros(n, first.pass_.dtype),
        uniq=np.zeros(n, first.uniq.dtype),
        nsnp=np.zeros(n, first.nsnp.dtype),
        llks=np.zeros((n,) + first.llks.shape[1:], np.float64),
        llk0s=np.zeros(n, np.float64),
        llk_ab=np.zeros((n,) + first.llk_ab.shape[1:], np.float64),
        llk_00=np.zeros((n,) + first.llk_00.shape[1:], np.float64),
    )
    for s in shards:
        idx = np.asarray([pos[b] for b in s.barcodes], dtype=np.int64)
        if not len(idx):
            continue
        np.add.at(out.totl, idx, s.totl)
        np.add.at(out.pass_, idx, s.pass_)
        np.add.at(out.uniq, idx, s.uniq)
        np.add.at(out.nsnp, idx, s.nsnp)
        np.add.at(out.llks, idx, np.asarray(s.llks, np.float64))
        np.add.at(out.llk0s, idx, np.asarray(s.llk0s, np.float64))
        np.add.at(out.llk_ab, idx, np.asarray(s.llk_ab, np.float64))
        np.add.at(out.llk_00, idx, np.asarray(s.llk_00, np.float64))
    return out


def stripe_rows(nproc: int, F: int) -> int:
    """RS, the rows of one process's stripe in each chunk of
    gather_results_sum_compact's reduce-scatter of an (N, F) f64 matrix
    over nproc processes: a chunk of nproc * RS rows holds at most
    _MAX_CHUNK_BYTES, and RS stays within [16, 4096]."""
    return max(16, min(4096, _MAX_CHUNK_BYTES // max(nproc * F * 8, 1)))


def gather_results_sum_compact(
    local: ShardResult,
    grid_alpha: Sequence[float],
    doublet_prior: float,
    device: torch.device,
) -> Optional[CompactShard]:
    """Genome-shard merge WITHOUT the full-tensor all-gather.

    gather_results_sum ships every process's full (n, V, V, A) f64 tensor
    to every process. But the LLKs only need to SUM before the decision,
    and the decision is per cell, so instead:

      1. all-gather barcode NAMES + integer counters (O(n) bytes) and
         derive the global sorted barcode order on every process;
      2. reduce-scatter of the barcode-aligned (N, V*V*A + A + V + 1)
         f64 LLK matrix, in chunks of P stripes of RS rows
         (``stripe_rows``): each process ends holding the SUMMED stripe
         of 1/P of the barcodes. JAX runs it on the devices
         (``lax.psum_scatter``); so does the port on the "nccl" route
         (each chunk copied to ``device`` from pinned memory, reduced
         over NCCL into a device tensor), while the "host" route reduces
         host tensors over gloo and copies each stripe to ``device``
         (``initialize`` chose the route);
      3. the decision pass (models/decision.decide, the multi-host analog
         of cmd_cram_demuxlet.cpp:713-828) runs on ``device`` per stripe,
         packing compact rows;
      4. ONE all-gather of the (N/P, 2V+A+11) compact stripes, host
         arrays over gloo, as JAX's ``process_allgather``.

    Merged CompactShard on process 0, None elsewhere. Output order and
    values match gather_results_sum + compact_from_result; the P-way sum
    reorders the shard sum: fp-identical for P=2 (a sum of two terms
    commutes), ~1 ulp beyond, so at P>2 rendered digits / 2-LLK-threshold
    calls can differ on exact near-ties vs the full-tensor merge (use
    --write-pair's full-tensor path when byte parity across output modes
    matters)."""
    from demuxlet_tpu_torch.models import decision as D

    nproc = process_count()
    if nproc == 1:
        m = merge_shards_sum([local])
        comp = D.compact_from_result(
            m.llk_ab, m.llk_00, grid_alpha, doublet_prior
        )
        return CompactShard(
            barcodes=m.barcodes, totl=m.totl, pass_=m.pass_, uniq=m.uniq,
            nsnp=m.nsnp, llks=m.llks, llk0s=m.llk0s, compact=comp,
        )
    n = len(local.barcodes)
    V = local.llks.shape[1]
    A = local.llk_00.shape[1]
    bc = _encode_barcodes(local.barcodes)
    counts = _allgather(np.asarray([n], dtype=np.int64))
    imat = np.stack(
        [np.asarray(local.totl, np.int64), np.asarray(local.pass_, np.int64),
         np.asarray(local.uniq, np.int64), np.asarray(local.nsnp, np.int64)],
        axis=1) if n else np.zeros((0, 4), np.int64)
    g_bc, g_i = _padded_gather([bc.astype(np.int32), imat], counts)

    # global sorted barcode order -- derived identically on every process
    names_by_p = []
    seen = set()
    order: List[str] = []
    for p in range(nproc):
        names = _decode_barcodes(g_bc[p][: int(counts[p])])
        names_by_p.append(names)
        for b in names:
            if b not in seen:
                seen.add(b)
                order.append(b)
    sorted_bcs = sorted(order)
    pos = {b: i for i, b in enumerate(sorted_bcs)}
    N = len(sorted_bcs)

    # barcode-aligned local LLK matrix (zeros where this shard has no row)
    F = V * V * A + A + V + 1
    RS = stripe_rows(nproc, F)
    CH = nproc * RS
    n_chunks = max(1, -(-max(N, 1) // CH))
    N_pad = n_chunks * CH
    loc = np.zeros((N_pad, F), np.float64)
    if n:
        my = np.asarray([pos[b] for b in local.barcodes], np.int64)
        o = V * V * A
        loc[my, :o] = np.asarray(local.llk_ab, np.float64).reshape(n, -1)
        loc[my, o : o + A] = np.asarray(local.llk_00, np.float64)
        loc[my, o + A : o + A + V] = np.asarray(local.llks, np.float64)
        loc[my, o + A + V] = np.asarray(local.llk0s, np.float64)

    dbl_w = torch.as_tensor(D.doublet_weights(V, grid_alpha, doublet_prior),
                            device=device)
    dbl_msk = torch.as_tensor(D.doublet_mask(V, A), device=device)
    _, group, where = _merge
    my_stripes = []
    for c in range(n_chunks):
        chunk = torch.from_numpy(loc[c * CH : (c + 1) * CH])
        if where.type == "cuda":
            chunk = chunk.pin_memory().to(where, non_blocking=True)
        y = torch.empty((RS, F), dtype=torch.float64, device=where)
        dist.reduce_scatter_tensor(y, chunk, op=dist.ReduceOp.SUM,
                                   group=group)
        y = y.to(device)
        o = V * V * A
        out = D.decide(y[:, :o].reshape(RS, V, V, A), y[:, o : o + A],
                       dbl_w, dbl_msk, doublet_prior)
        my_stripes.append(D.pack_rows(out, y[:, o + A : o + A + V],
                                      y[:, o + A + V]).cpu().numpy())
    g_s = _allgather(np.concatenate(my_stripes, axis=0))
    if process_index() != 0:
        return None

    NC = 2 * V + A + 11
    full = np.empty((N_pad, NC), np.float64)
    for c in range(n_chunks):
        for p in range(nproc):
            full[c * CH + p * RS : c * CH + (p + 1) * RS] = (
                g_s[p][c * RS : (c + 1) * RS]
            )
    llks, llk0s, d = D.unpack_block(full[:N], V, A)
    comp = D.concat([d])

    totl = np.zeros(N, np.int64)
    pass_ = np.zeros(N, np.int64)
    uniq = np.zeros(N, np.int64)
    nsnp = np.zeros(N, np.int64)
    for p in range(nproc):
        np_ = int(counts[p])
        if not np_:
            continue
        idx = np.asarray([pos[b] for b in names_by_p[p]], np.int64)
        gi = np.asarray(g_i[p][:np_], np.int64)
        np.add.at(totl, idx, gi[:, 0])
        np.add.at(pass_, idx, gi[:, 1])
        np.add.at(uniq, idx, gi[:, 2])
        np.add.at(nsnp, idx, gi[:, 3])
    return CompactShard(
        barcodes=sorted_bcs, totl=totl, pass_=pass_, uniq=uniq, nsnp=nsnp,
        llks=np.asarray(llks, np.float64),
        llk0s=np.asarray(llk0s, np.float64), compact=comp,
    )


def gather_results_sum(local: ShardResult) -> Optional[ShardResult]:
    """All-gather genome-shard results and SUM-merge by barcode; merged
    result on process 0, None elsewhere."""
    if process_count() == 1:
        return merge_shards_sum([local])
    shards = _gather_full(local)
    return None if shards is None else merge_shards_sum(shards)
