"""The CLI's host helpers, copied from ``demuxlet_tpu/cli.py`` (which
imports JAX in ``main``): the parser, the parameter echo, the pileup
ingest, the output opener and the host-oracle parity mode. Only the
import paths differ from the originals (tests/test_torch_host.py pins
each copy); ``demuxlet_tpu_torch/cli.py`` is the entry point.
"""

from __future__ import annotations

import argparse
import sys
import time

from demuxlet_tpu_torch.utils.logging_utils import error, notice


class _BgzfText:
    """Text adapter over the BGZF writer for compressed outputs."""

    def __init__(self, path: str):
        from demuxlet_tpu_torch.io.bgzf import BgzfWriter

        self._w = BgzfWriter(open(path, "wb"))

    def write(self, s: str) -> None:
        self._w.write(s.encode())

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _open_out(prefix: str, ext: str):
    """Open an output file for the given prefix + extension.

    A prefix ending in .gz implies BGZF-compressed outputs (the reference's
    hprintf writes through bgzf when the htsFile was opened compressed,
    hts_utils.cpp:1013-1034): --out x.gz writes x.single.gz etc."""
    if prefix.endswith(".gz"):
        return _BgzfText(prefix[:-3] + ext + ".gz")
    return open(prefix + ext, "w")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="demuxlet-tpu",
        description=(
            "TPU-native droplet demultiplexing: deconvolute sample identity "
            "and detect doublets from pooled single-cell data using natural "
            "genetic variation."
        ),
    )
    g = p.add_argument_group("Options for input SAM/BAM/CRAM")
    g.add_argument("--sam", required=True, help="Input SAM/BAM file, coordinate-sorted")
    g.add_argument("--tag-group", default="CB", help="Tag for cell barcodes (CB)")
    g.add_argument("--tag-UMI", default="UB", help="Tag for UMIs (UB)")

    g = p.add_argument_group("Options for input VCF/BCF")
    g.add_argument("--vcf", required=True, help="Input VCF/BCF with genotypes")
    g.add_argument(
        "--field",
        default="GP",
        help="FORMAT field to extract genotype/likelihood/posterior (GT/GP/PL)",
    )
    g.add_argument(
        "--geno-error",
        type=float,
        default=0.01,
        help="Genotype error rate (must be used with --field GT)",
    )
    g.add_argument("--min-mac", type=int, default=1, help="Minimum minor allele count")
    g.add_argument(
        "--min-callrate", type=float, default=0.5, help="Minimum call rate"
    )
    g.add_argument(
        "--sm", action="append", default=[], help="Sample ID to include (repeatable)"
    )
    g.add_argument("--sm-list", default=None, help="File with sample IDs to include")
    g.add_argument(
        "--ref",
        default=None,
        help=(
            "FASTA (with .fai) or .fai giving chromosome lengths for "
            "-_BEG_-/-_END_- chunk patterns (genomeChunk.cpp:91-126); "
            "defaults to lengths from the BAM header"
        ),
    )
    g.add_argument(
        "--chunk-unit",
        type=int,
        default=None,
        help="Chunk size in bp for -_BEG_-/-_END_- VCF filename patterns",
    )

    g = p.add_argument_group("Output Options")
    g.add_argument("--out", required=True, help="Output file prefix")
    g.add_argument(
        "--alpha",
        action="append",
        type=float,
        default=None,
        help="Grid of alpha to search (repeatable; default 0, 0.5)",
    )
    g.add_argument("--write-pair", action="store_true", help="Write the (HUGE) pair file")
    g.add_argument(
        "--doublet-prior", type=float, default=0.5, help="Prior of doublet"
    )
    g.add_argument("--sam-verbose", type=int, default=1000000)
    g.add_argument("--vcf-verbose", type=int, default=10000)

    g = p.add_argument_group("Read filtering Options")
    g.add_argument("--cap-BQ", type=int, default=40, help="Maximum base quality cap")
    g.add_argument("--min-BQ", type=int, default=13, help="Minimum base quality")
    g.add_argument("--min-MQ", type=int, default=20, help="Minimum mapping quality")
    g.add_argument("--min-TD", type=int, default=0, help="Minimum tail distance")
    g.add_argument(
        "--excl-flag", type=int, default=0x0F04, help="SAM flags to exclude"
    )

    g = p.add_argument_group("Cell/droplet filtering options")
    g.add_argument("--group-list", default=None, help="Barcode whitelist file")
    g.add_argument(
        "--num-shards",
        type=int,
        default=1,
        help=(
            "Split barcodes into N deterministic stripes (crc32 hash); this "
            "process handles stripe --shard-id. The TPU-native analog of "
            "manual --group-list sharding"
        ),
    )
    g.add_argument("--shard-id", type=int, default=0, help="Stripe index for --num-shards")
    g.add_argument(
        "--shard-by",
        default="barcode",
        choices=["barcode", "genome"],
        help=(
            "--num-shards decomposition: 'barcode' stripes cells by crc32 "
            "(disjoint outputs, concat-merged); 'genome' gives each shard "
            "a contiguous bp-balanced genome span — the BAI-seeked ingest "
            "scans ~1/N of the BAM, SNPs partition by position, and "
            "per-shard LLK contributions SUM at the distributed merge"
        ),
    )
    g.add_argument(
        "--dist-coordinator",
        default=None,
        metavar="HOST:PORT",
        help=(
            "jax.distributed coordinator address; with --num-shards N and "
            "--shard-id k this process joins an N-process run (process k), "
            "shard results all-gather compactly, and process 0 writes the "
            "single merged output set"
        ),
    )
    g.add_argument("--min-total", type=int, default=0)
    g.add_argument("--min-uniq", type=int, default=0)
    g.add_argument("--min-snp", type=int, default=0)

    g = p.add_argument_group("TPU engine options")
    g.add_argument(
        "--mesh",
        default="auto",
        metavar="auto|none|BxS",
        help=(
            "Multi-chip device mesh: 'auto' data-parallels barcodes over "
            "all local devices (no-op with one device), 'none' disables, "
            "'BxS' shards barcodes x SNP-slots (exact mode only; psum over "
            "the slot axis)"
        ),
    )
    g.add_argument(
        "--device",
        default="auto",
        choices=["auto", "tpu", "cpu"],
        help="Execution platform (auto = default JAX backend)",
    )
    g.add_argument(
        "--precision",
        default="f64",
        choices=["f64", "f32"],
        help="Device compute precision (f64 = reference parity)",
    )
    g.add_argument(
        "--mode",
        default="exact",
        choices=["exact", "fast", "parity"],
        help=(
            "exact: f64 device kernels (printed values reference-identical; "
            "exact ulp-ties between mirrored (j,k,0.5) doublet pairs may "
            "resolve to the mirrored order). fast: f32 Pallas pair-search "
            "kernel (TPU production mode; calls identical, LLKs approximate "
            "in the last printed digit). parity: bit-faithful host oracle "
            "replicating the reference's per-UMI scalar loop order — "
            "byte-exact outputs incl. tie direction (small inputs)"
        ),
    )
    g.add_argument(
        "--exact-kernel",
        default="auto",
        choices=["auto", "pallas", "xla"],
        help=(
            "Exact-mode kernel: pallas = df32 (double-single f32) Pallas "
            "pair kernel (TPU; ~1e-10 of f64), xla = f64 XLA kernels; "
            "auto picks pallas on TPU"
        ),
    )
    g.add_argument("--cell-block", type=int, default=2048,
                   help="Cells per device batch (2048 peaks both Pallas "
                        "kernels' throughput on v5e; 4096 regresses)")
    g.add_argument(
        "--slot-chunk", type=int, default=512, help="SNP-slot chunk per scan step"
    )
    g.add_argument(
        "--ingest",
        default="auto",
        choices=["auto", "native", "python"],
        help="Host pileup implementation (native C++ if built)",
    )
    g.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="Write a JAX profiler trace of the device passes to DIR",
    )
    g.add_argument(
        "--spool",
        default=None,
        metavar="DIR",
        help=(
            "Spool per-block results to DIR for checkpoint/resume: a rerun "
            "with the same inputs skips completed blocks"
        ),
    )
    return p


def _run_parity(args, scl, table, grid_alpha, t_start):
    """Byte-exact host path: the NumPy oracle's reference-ordered scalar
    loops (oracle/numpy_oracle.py implements cmd_cram_demuxlet.cpp:415-875
    op-for-op, including per-UMI normalization order and ulp-tie behavior).
    Requires the dict pileup (python ingest)."""
    from demuxlet_tpu_torch import oracle as O

    if not hasattr(scl, "umis"):
        error(
            "--mode parity requires the Python ingest (per-UMI order); "
            "rerun with --ingest python"
        )
    gp0s = O.compute_gp0s(scl)
    llks, llk0s = O.pass1_singlet(scl, gp0s)
    filt = dict(
        min_total=args.min_total, min_uniq=args.min_uniq, min_snp=args.min_snp
    )
    single = O.write_single(scl, llks, llk0s, **filt)
    sing2, pair, best = O.pass2_outputs(
        scl, gp0s, grid_alpha, doublet_prior=args.doublet_prior,
        write_pair=args.write_pair, **filt,
    )
    with _open_out(args.out, ".single") as fh:
        fh.write("\n".join(single) + "\n")
    with _open_out(args.out, ".sing2") as fh:
        fh.write("\n".join(sing2) + "\n")
    with _open_out(args.out, ".best") as fh:
        fh.write("\n".join(best) + "\n")
    if args.write_pair and pair is not None:
        with _open_out(args.out, ".pair") as fh:
            fh.write("\n".join(pair) + "\n")
    notice("Finished writing output files")
    notice("Total wall-clock time: %.3fs", time.time() - t_start)
    return 0


def _ingest(args, table, group_set):
    """Dispatch host pileup: native C++ ingest if available, else Python."""
    use_native = False
    if args.mode == "parity" and args.ingest == "auto":
        args.ingest = "python"  # parity needs the per-UMI dict pileup
    if args.ingest in ("auto", "native"):
        try:
            from demuxlet_tpu_torch.native import ingest as native_ingest

            use_native = native_ingest.available()
        except Exception:
            use_native = False
        if args.ingest == "native" and not use_native:
            error("--ingest native requested but the native library is not built")
    if use_native:
        from demuxlet_tpu_torch.native import ingest as native_ingest

        return native_ingest.build_pileup(
            args.sam,
            table,
            tag_group=args.tag_group,
            tag_umi=args.tag_UMI,
            cap_bq=args.cap_BQ,
            min_bq=args.min_BQ,
            min_td=args.min_TD,
            min_mq=args.min_MQ,
            excl_flag=args.excl_flag,
            group_set=group_set,
            n_shards=args.num_shards if args.shard_by == "barcode" else 1,
            shard_id=args.shard_id if args.shard_by == "barcode" else 0,
            sam_verbose=args.sam_verbose,
            regions=getattr(args, "_genome_regions", None),
        )
    from demuxlet_tpu_torch.host.pileup import build_pileup

    if args.sam.endswith(".cram"):
        from demuxlet_tpu_torch.io.cram import CramReader

        notice("CRAM input: using the Python CRAM 3.0 reader")
        rdr = CramReader(args.sam, min_mq=args.min_MQ, excl_flag=args.excl_flag)
    else:
        from demuxlet_tpu_torch.io.bam import AlignmentReader

        rdr = AlignmentReader(
            args.sam, min_mq=args.min_MQ, excl_flag=args.excl_flag
        )
    return build_pileup(
        rdr,
        table,
        tag_group=args.tag_group,
        tag_umi=args.tag_UMI,
        cap_bq=args.cap_BQ,
        min_bq=args.min_BQ,
        min_td=args.min_TD,
        group_set=group_set,
        n_shards=args.num_shards if args.shard_by == "barcode" else 1,
        shard_id=args.shard_id if args.shard_by == "barcode" else 0,
        sam_verbose=args.sam_verbose,
        regions=getattr(args, "_genome_regions", None),
    )


def _echo_params(args, grid_alpha) -> None:
    """Parameter echo in the spirit of paramList::Status (params.cpp:552-574)."""
    notice("Available Options")
    rows = [
        ("sam", args.sam),
        ("tag-group", args.tag_group),
        ("tag-UMI", args.tag_UMI),
        ("vcf", args.vcf),
        ("field", args.field),
        ("geno-error", args.geno_error),
        ("min-mac", args.min_mac),
        ("min-callrate", args.min_callrate),
        ("sm", ",".join(args.sm) if args.sm else ""),
        ("sm-list", args.sm_list or ""),
        ("out", args.out),
        ("alpha", ",".join(str(a) for a in grid_alpha)),
        ("write-pair", args.write_pair),
        ("doublet-prior", args.doublet_prior),
        ("cap-BQ", args.cap_BQ),
        ("min-BQ", args.min_BQ),
        ("min-MQ", args.min_MQ),
        ("min-TD", args.min_TD),
        ("excl-flag", args.excl_flag),
        ("group-list", args.group_list or ""),
        ("num-shards", args.num_shards),
        ("shard-id", args.shard_id),
        ("min-total", args.min_total),
        ("min-uniq", args.min_uniq),
        ("min-snp", args.min_snp),
    ]
    for k, v in rows:
        sys.stderr.write(f"   --{k} [{v}]\n")
    sys.stderr.flush()
