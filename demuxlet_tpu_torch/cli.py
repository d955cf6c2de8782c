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
exact ``--precision f32``) through ``DemuxEngine.run``, as the JAX CLI
chooses; ``--mode parity`` runs the host oracle. A NOTICE names the route
each run took. Multi-device meshes, ``--dist-coordinator`` and ``--device
tpu`` fail loudly with a DemuxError naming the ROADMAP item that will port
them; nothing falls back to another mode.
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


def _refuse_unported(args) -> None:
    """DemuxError for every option the port does not cover yet, and for
    fast mode's cap-BQ > 126 (the JAX engine's refusal) before any input
    is read."""
    if args.dist_coordinator:
        error("--dist-coordinator (multi-host%s) is not ported to PyTorch "
              "yet (ROADMAP queue 1, item 15)",
              ", genome shards included" if args.shard_by == "genome"
              else "")
    if args.mode == "fast" and args.cap_BQ > 126:
        error("--cap-BQ > 126 is not representable by the fast-mode u8 "
              "observation codes; use --mode exact")


def _check_single_device(args) -> None:
    """A mesh that would use more than one device is refused (ROADMAP
    queue 1, item 14); 'auto' counts the visible CUDA devices."""
    if args.mesh == "none":
        return
    if args.mesh == "auto":
        import torch

        n = torch.cuda.device_count() if args.device != "cpu" else 1
    else:
        try:
            n_b, n_s = (int(t) for t in args.mesh.lower().split("x"))
        except ValueError:
            error("Cannot parse --mesh %s (expected auto|none|BxS)", args.mesh)
        n = n_b * n_s
    if n > 1:
        error("--mesh %s would use %d devices; multi-GPU is not ported to "
              "PyTorch yet (ROADMAP queue 1, item 14). Use --mesh none",
              args.mesh, n)


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
    """torch.profiler over the device passes under --profile (CPU and
    CUDA activities on the card, CPU on the CPU), else a null context."""
    if not args.profile:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.time()
    grid_alpha = args.alpha if args.alpha else [0.0, 0.5]
    if args.mode != "parity":
        _refuse_unported(args)
        _check_single_device(args)
        from demuxlet_tpu_torch.utils.device import resolve_device

        if args.device == "tpu":
            error("--device tpu is not a PyTorch device; use auto (CUDA) "
                  "or cpu")
        device = resolve_device(args.device)
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
            mode=args.mode, exact_kernel=args.exact_kernel, device=device)

    scl, ctr = _ingest(args, table, group_set)
    ctr.report(scl.nbcs, scl.nsnps)
    t_ingest_done = time.time()
    notice("Phase timing: VCF load %.2fs, pileup ingest %.2fs",
           t_vcf_done - t_start, t_ingest_done - t_vcf_done)

    notice("Starting to identify best matching individual IDs")
    if args.mode == "parity":
        return _run_parity(args, scl, table, grid_alpha, t_start)

    from demuxlet_tpu_torch.models import outputs as out_mod
    from demuxlet_tpu_torch.models.engine import cell_stats

    # the compact device decision pass unless the full tensors are needed
    # (the .pair file, the spool, a shard's partial LLKs) or the engine
    # takes the dense route, which has no compact step
    use_compact = (not args.write_pair and not args.spool
                   and genome_regions is None and eng.dense_reason is None)
    t_eng = time.time()
    with _profiler(args, device) as prof:
        if use_compact:
            llks, llk0s, compact = eng.run_compact(scl, args.doublet_prior)
        else:
            res = eng.run(scl, spool_dir=args.spool)
            llks, llk0s = res.llks, res.llk0s
        if prof is not None and device.type == "cuda":
            torch.cuda.synchronize()
    t_eng_done = time.time()
    notice("Route: %s, %s", "run_compact" if use_compact else "run", eng.route)
    if prof is not None:
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "torch_trace.json")
        prof.export_chrome_trace(path)
        notice("Profiler trace written to %s", path)
    if scl.nbcs:
        notice(
            "Device passes: %.2fs (%.0f barcodes/s, mode=%s, device=%s)",
            t_eng_done - t_eng,
            scl.nbcs / max(t_eng_done - t_eng, 1e-9),
            args.mode, device,
        )
    stats = cell_stats(scl)
    filt = dict(
        min_total=args.min_total, min_uniq=args.min_uniq, min_snp=args.min_snp
    )
    with _open_out(args.out, ".single") as fh:
        out_mod.write_single(fh, stats, table.sample_ids, llks, llk0s, **filt)
    with contextlib.ExitStack() as files:
        s2 = files.enter_context(_open_out(args.out, ".sing2"))
        sb = files.enter_context(_open_out(args.out, ".best"))
        if use_compact:
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
    notice("Total wall-clock time: %.3fs", time.time() - t_start)
    return 0


if __name__ == "__main__":
    sys.exit(main())
