"""Command-line entry of the PyTorch port: ``python -m demuxlet_tpu_torch.cli``.

Same options and outputs as ``demuxlet_tpu.cli`` (its parser, parameter
echo, ingest, output opener and host-oracle parity mode are the port's
copies in ``cli_common.py``), with the device passes on PyTorch.
``--device auto`` means the CUDA card or an error, ``cpu`` runs the plain
kernel versions (tests), ``tpu`` is an error.

``--mode exact`` (the default; ``--exact-kernel auto|pallas`` both select
the port's f64 kernels) and ``--mode fast`` run through
``DemuxEngine.run_compact``; ``--write-pair``, ``--spool``, a genome shard
and the dense route (``--exact-kernel xla``, exact ``--cap-BQ`` > 126,
exact ``--precision f32``, a mesh's slot axis) through
``DemuxEngine.run``, as the JAX CLI chooses; ``--mode parity`` runs the
host oracle. A NOTICE names the route each run took. ``--mesh auto|BxS``
spreads blocks over this process's devices (``parallel/mesh.py``);
``--dist-coordinator host:port`` with ``--num-shards N --shard-id k``
joins N processes over gloo, each taking its barcode stripe or genome
shard, and process 0 writes the merged outputs
(``parallel/multihost.py``); the genome shards' reduce-scatter runs over
NCCL on the cards when each process has a card of its own, and a NOTICE
names its route. ``--device tpu`` fails with a DemuxError;
nothing falls back to another mode.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

from demuxlet_tpu_torch.cli_common import (
    _echo_params,
    _ingest,
    _open_out,
    _run_parity,
    build_parser,
)
from demuxlet_tpu_torch.utils.logging_utils import error, notice


def _check_options(args) -> None:
    """The JAX CLI's refusals, before any input is read: a coordinator
    without shards, and fast mode's cap-BQ > 126 (the JAX engine's)."""
    if args.dist_coordinator and args.num_shards < 2:
        error("--dist-coordinator requires --num-shards >= 2")
    if args.mode == "fast" and args.cap_BQ > 126:
        error("--cap-BQ > 126 is not representable by the fast-mode u8 "
              "observation codes; use --mode exact")


def _build_mesh(args, device):
    """The device mesh per --mesh (None: one device), with the JAX CLI's
    rules: 'auto' takes every CUDA device this process sees as n x 1 (one
    device on the CPU: no mesh); BxS needs B*S devices, S a power of two
    and, for S > 1, exact mode. On the CPU a BxS mesh has B*S members,
    all of them the CPU (the counterpart of the JAX tests' virtual
    devices). Blocks are whole per mesh row, so --cell-block needs no
    rounding."""
    if args.mesh == "none":
        return None
    import torch

    if device.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = None  # as many CPU members as the mesh asks for
    if args.mesh == "auto":
        n_b, n_s = len(devs) if devs else 1, 1
    else:
        try:
            n_b, n_s = (int(t) for t in args.mesh.lower().split("x"))
        except ValueError:
            error("Cannot parse --mesh %s (expected auto|none|BxS)", args.mesh)
    if n_b * n_s <= 1:
        return None
    if devs is None:
        devs = [device] * (n_b * n_s)
    if n_b * n_s > len(devs):
        error(
            "--mesh %dx%d needs %d local devices, have %d",
            n_b, n_s, n_b * n_s, len(devs),
        )
    if args.mode == "fast" and n_s != 1:
        error("--mesh BxS with S > 1 requires --mode exact (slot-axis sum)")
    if n_s & (n_s - 1):
        error("--mesh slot axis must be a power of two (got %d)", n_s)
    from demuxlet_tpu_torch.parallel import mesh as pmesh

    mesh = pmesh.make_mesh(n_b=n_b, n_s=n_s, devices=devs[: n_b * n_s])
    notice("Device mesh: %d (barcodes) x %d (slots) over %s", n_b, n_s,
           ", ".join(str(d) for row in mesh.devices for d in row))
    return mesh


def _genome_regions(args):
    """This process's regions of a genome-sharded run (``--shard-by
    genome --num-shards N``, N > 1), else None: ``split_genome_shards``
    over the BAM's reference lengths, as demuxlet_tpu.cli.main computes
    them before the VCF load."""
    if args.shard_by != "genome" or args.num_shards <= 1:
        return None
    from demuxlet_tpu_torch.native.ingest import _bam_refs_len
    from demuxlet_tpu_torch.utils.intervals import split_genome_shards

    shards = split_genome_shards(_bam_refs_len(args.sam), args.num_shards)
    return shards[args.shard_id]


def _spool_dir(args):
    """--spool DIR, or for shard k of N > 1 its own DIR/shard<k>of<N>:
    block files are named by local cell ids, which every shard numbers
    from 0, so shards sharing DIR would resume each other's blocks (as
    the JAX CLI's do)."""
    if args.spool and args.num_shards > 1:
        return os.path.join(args.spool,
                            "shard%dof%d" % (args.shard_id, args.num_shards))
    return args.spool


def _load_table(args, genome_regions=None):
    """The SNP table, as demuxlet_tpu.cli.main loads it (chunk patterns
    included), restricted to genome_regions when given; a genome shard may
    hold no SNP."""
    from demuxlet_tpu_torch.io.vcf import (
        expand_chunk_pattern,
        filter_snp_table,
        load_snp_table,
        merge_snp_tables,
    )

    kw = dict(
        field_name=args.field,
        geno_error=args.geno_error,
        sm_ids=args.sm,
        sm_list_path=args.sm_list,
        min_mac=args.min_mac,
        min_callrate=args.min_callrate,
        verbose=args.vcf_verbose,
    )
    if any(t in args.vcf for t in ("-_CHR_-", "-_BEG_-", "-_END_-")):
        from demuxlet_tpu_torch.native.ingest import _bam_refs_len

        if args.ref:
            from demuxlet_tpu_torch.utils.intervals import read_fai

            fai = args.ref if args.ref.endswith(".fai") else args.ref + ".fai"
            chrom_lengths = read_fai(fai)
        else:
            chrom_lengths = _bam_refs_len(args.sam)
        files = expand_chunk_pattern(
            args.vcf, chrom_lengths, unit=args.chunk_unit
        )
        if not files:
            error("No chunk files found for pattern %s", args.vcf)
        table = merge_snp_tables([load_snp_table(f, **kw) for f in files])
        if genome_regions is not None:
            table = filter_snp_table(table, genome_regions)
    else:
        table = load_snp_table(args.vcf, regions=genome_regions, **kw)
    if table.nsnps == 0 and genome_regions is None:
        error("Cannot read any single variant from %s", args.vcf)
    return table


def _profiler(args, device):
    """torch.profiler over the device passes, ``cell_stats`` and the
    output writes under --profile (CPU and CUDA activities on the card,
    CPU on the CPU; every thread's ranges, so the engine's prefetch
    threads' prep spans too, where this torch records them), else a null
    context."""
    if not args.profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    from demuxlet_tpu_torch.utils.spans import profiler_config

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, experimental_config=profiler_config())


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not args.dist_coordinator:
        return _main(args)
    from demuxlet_tpu_torch.parallel import multihost as mh

    try:
        return _main(args)
    finally:
        mh.shutdown()


def _main(args) -> int:
    t_start = time.time()
    grid_alpha = args.alpha if args.alpha else [0.0, 0.5]
    _check_options(args)
    mesh = device = None
    if args.mode != "parity":
        from demuxlet_tpu_torch.utils.device import resolve_device

        if args.device == "tpu":
            error("--device tpu is not a PyTorch device; use auto (CUDA) "
                  "or cpu")
        device = resolve_device(args.device)
        mesh = _build_mesh(args, device)
    n_procs = 1
    if args.dist_coordinator:
        from demuxlet_tpu_torch.parallel import multihost as mh

        pid, n_procs = mh.initialize(
            args.dist_coordinator, args.num_shards, args.shard_id,
            device=device,
        )
        notice(
            "torch.distributed initialized: process %d of %d (%s); gathers "
            "over gloo, the genome-shard reduce-scatter on the %s route",
            pid, n_procs, args.dist_coordinator, mh.current_route(),
        )
    for tag, name in ((args.tag_group, "group"), (args.tag_UMI, "UMI")):
        if tag and len(tag) != 2:
            error(
                "Cannot recognize %s tag %s. It is suppose to be a length 2 string",
                name,
                tag,
            )

    _echo_params(args, grid_alpha)

    group_set = None
    if args.group_list:
        group_set = set()
        with open(args.group_list) as fh:
            for line in fh:
                tok = line.split()
                if tok:
                    group_set.add(tok[0])
        notice(
            "Finished loading %d droplet/cell barcodes to consider", len(group_set)
        )

    genome_regions = _genome_regions(args)
    if genome_regions is not None:
        args._genome_regions = genome_regions  # read by the ingest
    table = _load_table(args, genome_regions)
    if genome_regions is not None:
        if not args.dist_coordinator:
            notice(
                "WARNING: genome-sharded run without --dist-coordinator "
                "writes PARTIAL per-shard LLKs (this shard's SNPs only); "
                "contributions from all shards must be sum-merged"
            )
        notice(
            "Genome shard %d/%d: %d regions, %d SNPs",
            args.shard_id, args.num_shards, len(genome_regions),
            table.nsnps,
        )
    t_vcf_done = time.time()
    eng = None
    if args.mode != "parity":
        import torch

        from demuxlet_tpu_torch.models.engine import DemuxEngine

        eng = DemuxEngine(
            table.gps, grid_alpha, cap_bq=args.cap_BQ,
            cell_block=args.cell_block, slot_chunk=args.slot_chunk,
            dtype=torch.float64 if args.precision == "f64" else torch.float32,
            mode=args.mode, exact_kernel=args.exact_kernel, device=device,
            mesh=mesh)

    scl, ctr = _ingest(args, table, group_set)
    ctr.report(scl.nbcs, scl.nsnps)
    t_ingest_done = time.time()
    notice("Phase timing: VCF load %.2fs, pileup ingest %.2fs",
           t_vcf_done - t_start, t_ingest_done - t_vcf_done)

    notice("Starting to identify best matching individual IDs")
    if args.mode == "parity":
        return _run_parity(args, scl, table, grid_alpha, t_start)

    # the compact device decision pass unless the full tensors are needed
    # (the .pair file, the spool, a shard's partial LLKs) or the engine
    # takes the dense route, which has no compact step
    use_compact = (not args.write_pair and not args.spool
                   and genome_regions is None and eng.dense_reason is None)
    with _profiler(args, device) as prof:
        wrote = _demux(args, eng, scl, table, grid_alpha, use_compact, mesh,
                       device, n_procs, genome_regions, prof)
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "torch_trace.json")
        prof.export_chrome_trace(path)
        notice("Profiler trace written to %s", path)
    if wrote:
        notice("Total wall-clock time: %.3fs", time.time() - t_start)
    return 0


def _demux(args, eng, scl, table, grid_alpha, use_compact, mesh, device,
           n_procs, genome_regions, prof):
    """The device passes, ``cell_stats``, the merge across processes and
    the output writes: True once this process has written the outputs,
    False on a process whose results went to process 0."""
    import torch

    from demuxlet_tpu_torch.models import outputs as out_mod
    from demuxlet_tpu_torch.models.engine import cell_stats

    t_eng = time.time()
    compact = res = None
    if use_compact:
        llks, llk0s, compact = eng.run_compact(scl, args.doublet_prior)
    else:
        res = eng.run(scl, spool_dir=_spool_dir(args))
        llks, llk0s = res.llks, res.llk0s
    if prof is not None and device.type == "cuda":
        for dev in ({d for row in mesh.devices for d in row}
                    if mesh is not None else (device,)):
            torch.cuda.synchronize(dev)
    t_eng_done = time.time()
    notice("Route: %s, %s", "run_compact" if use_compact else "run", eng.route)
    if scl.nbcs:
        notice(
            "Device passes: %.2fs (%.0f barcodes/s, mode=%s, device=%s)",
            t_eng_done - t_eng,
            scl.nbcs / max(t_eng_done - t_eng, 1e-9),
            args.mode, device,
        )
    stats = cell_stats(scl)
    if n_procs > 1:
        t_merge = time.time()
        merged = _gather(args, stats, llks, llk0s, compact, res, grid_alpha,
                         genome_regions is not None, device)
        notice("Merge across %d processes: %.3fs", n_procs,
               time.time() - t_merge)
        if merged is None:
            notice("%sShard %d: results gathered to process 0",
                   "Genome " if genome_regions is not None else "",
                   args.shard_id)
            return False
        stats, llks, llk0s, compact, res = merged
    filt = dict(
        min_total=args.min_total, min_uniq=args.min_uniq, min_snp=args.min_snp
    )
    with _open_out(args.out, ".single") as fh:
        out_mod.write_single(fh, stats, table.sample_ids, llks, llk0s, **filt)
    with contextlib.ExitStack() as files:
        s2 = files.enter_context(_open_out(args.out, ".sing2"))
        sb = files.enter_context(_open_out(args.out, ".best"))
        if compact is not None:
            out_mod.write_pass2_compact(
                stats, table.sample_ids, compact, grid_alpha,
                args.doublet_prior, s2, sb, **filt,
            )
        else:
            wpair = (files.enter_context(_open_out(args.out, ".pair"))
                     if args.write_pair else None)
            out_mod.write_pass2(
                stats, table.sample_ids, res.llk_ab, res.llk_00, grid_alpha,
                args.doublet_prior, s2, sb, wpair, **filt,
            )
    notice("Finished writing output files")
    return True


def _gather(args, stats, llks, llk0s, compact, res, grid_alpha, genome,
            device):
    """This process's rows merged on process 0, as the JAX CLI merges
    them: a genome shard's LLKs sum (the full tensors for --write-pair or
    --spool, else the reduce-scatter and a decision pass per stripe on
    ``device``), a barcode stripe's rows concatenate (the full tensors for
    --write-pair or --spool, else the compact rows; the dense route's are
    decided on the host first). Returns (stats, llks, llk0s, compact,
    res) on process 0, with compact or res None as the writer takes it,
    and None on every other process."""
    from demuxlet_tpu_torch.models import decision as D
    from demuxlet_tpu_torch.models import outputs as out_mod
    from demuxlet_tpu_torch.models.engine import EngineResult
    from demuxlet_tpu_torch.parallel import multihost as mh

    full = args.write_pair or args.spool
    if genome or full:
        local = mh.ShardResult(
            barcodes=stats.barcodes, totl=stats.totl, pass_=stats.pass_,
            uniq=stats.uniq, nsnp=stats.nsnp, llks=res.llks,
            llk0s=res.llk0s, llk_ab=res.llk_ab, llk_00=res.llk_00,
        )
    if genome and not full:
        merged = mh.gather_results_sum_compact(
            local, grid_alpha, args.doublet_prior, device=device)
    elif full:
        merged = (mh.gather_results_sum if genome
                  else mh.gather_results)(local)
    else:
        if compact is None:
            compact = D.compact_from_result(
                res.llk_ab, res.llk_00, grid_alpha, args.doublet_prior)
        merged = mh.gather_compact(mh.CompactShard(
            barcodes=stats.barcodes, totl=stats.totl, pass_=stats.pass_,
            uniq=stats.uniq, nsnp=stats.nsnp, llks=llks, llk0s=llk0s,
            compact=compact,
        ))
    if merged is None:
        return None
    stats = out_mod.CellStats(
        barcodes=merged.barcodes, totl=merged.totl, pass_=merged.pass_,
        uniq=merged.uniq, nsnp=merged.nsnp,
    )
    if full:
        res = EngineResult(merged.llks, merged.llk0s, merged.llk_ab,
                           merged.llk_00)
        return stats, res.llks, res.llk0s, None, res
    return stats, merged.llks, merged.llk0s, merged.compact, None


if __name__ == "__main__":
    sys.exit(main())
