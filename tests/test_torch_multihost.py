"""The port's multi-process merges (``demuxlet_tpu_torch/parallel/
multihost.py``) on the CPU: the copied helpers and merges against the JAX
module's on the same seeded shards, the ingest's barcode stripe against
the JAX owns_barcode, each gather with one process against its merge,
gather_results_sum_compact over several chunks in two processes, and two
CLI processes joined over gloo on localhost, whose process 0 writes what
one process writes, as tests/test_multihost.py holds the JAX CLI."""

import dataclasses
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from demuxlet_tpu.models import decision as JD
from demuxlet_tpu.parallel import multihost as jmh
from demuxlet_tpu_torch.models import decision as TD
from demuxlet_tpu_torch.parallel import multihost as tmh

torch.set_num_threads(2)

V, A = 3, 2
GRID = [0.0, 0.5]


def _fields(x):
    return [(f.name, f.type) for f in dataclasses.fields(x)]


def test_copied_helpers_equal_jax():
    """ShardResult, CompactShard, the compact column names and
    owns_barcode / shard_filter equal the JAX module's."""
    assert _fields(tmh.ShardResult) == _fields(jmh.ShardResult)
    assert _fields(tmh.CompactShard) == _fields(jmh.CompactShard)
    assert tmh._COMPACT_F64 == jmh._COMPACT_F64
    assert tmh._COMPACT_I64 == jmh._COMPACT_I64
    bcs = ["BC%05d" % i for i in range(500)] + ["AAACCTG-1", ""]
    for n in (1, 2, 5):
        for k in range(n):
            keep = tmh.shard_filter(k, n)
            assert [tmh.owns_barcode(b, k, n) for b in bcs] == \
                [jmh.owns_barcode(b, k, n) for b in bcs]
            assert [keep(b) for b in bcs] == [jmh.owns_barcode(b, k, n)
                                              for b in bcs]


@pytest.mark.parametrize("ingest", ["python", "native"])
def test_ingest_stripe_is_jax_owns_barcode(tmp_path, ingest):
    """The barcodes each of 3 shards' ingest keeps (--num-shards 3
    --shard-id k, Python and native) are those the JAX owns_barcode gives
    shard k: the stripes partition the cells of the unsharded ingest."""
    from fixtures import random_workload, write_bam, write_vcf

    from demuxlet_tpu_torch.host import pileup as tp
    from demuxlet_tpu_torch.io import bam as tbam
    from demuxlet_tpu_torch.io import vcf as tvcf
    from demuxlet_tpu_torch.native import ingest as tni

    contigs, names, variants, reads, _ = random_workload(
        random.Random(5), n_cells=30, n_snps=30, n_samples=3,
        reads_per_cell=20)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    tab = tvcf.load_snp_table(vcf, field_name="GT")
    if ingest == "native":
        assert tni.available()
        barcodes = lambda **kw: tni.build_pileup(bam, tab, **kw)[0].barcodes
    else:
        barcodes = lambda **kw: tp.build_pileup(
            tbam.AlignmentReader(bam), tab, **kw)[0].barcodes
    every = barcodes()
    assert len(every) == 30
    kept = [barcodes(n_shards=3, shard_id=k) for k in range(3)]
    for k in range(3):
        assert sorted(kept[k]) == sorted(
            b for b in every if jmh.owns_barcode(b, k, 3))
    assert sorted(b for bs in kept for b in bs) == sorted(every)


def _shards(seed, n_shards=3, overlap=False, n_cells=40):
    """Seeded shard results: disjoint barcode stripes, or (overlap) genome
    shards sharing most barcodes; the port's and the JAX module's
    ShardResult of the same arrays."""
    rng = np.random.default_rng(seed)
    names = ["BC%05d" % i for i in rng.permutation(n_cells)]
    out = []
    for k in range(n_shards):
        if overlap:
            bcs = [b for b in names if rng.random() < 0.8]
        else:
            bcs = names[k::n_shards]
        n = len(bcs)
        arrs = dict(
            totl=rng.integers(0, 90, n), pass_=rng.integers(0, 90, n),
            uniq=rng.integers(0, 90, n), nsnp=rng.integers(0, 40, n),
            llks=rng.normal(-40, 9, (n, V)), llk0s=rng.normal(-40, 9, n),
            llk_ab=rng.normal(-40, 9, (n, V, V, A)),
            llk_00=rng.normal(-40, 9, (n, A)))
        out.append((tmh.ShardResult(barcodes=bcs, **arrs),
                    jmh.ShardResult(barcodes=list(bcs), **arrs)))
    return out


def _assert_same(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if f.name == "compact":
            _assert_same(g, w)
        elif isinstance(w, list):
            assert g == w, f.name
        else:
            np.testing.assert_array_equal(g, np.asarray(w), err_msg=f.name)


def test_merge_shards_equals_jax():
    shards = _shards(1)
    _assert_same(tmh.merge_shards([t for t, _ in shards]),
                 jmh.merge_shards([j for _, j in shards]))


def test_merge_shards_sum_equals_jax():
    shards = _shards(2, overlap=True)
    _assert_same(tmh.merge_shards_sum([t for t, _ in shards]),
                 jmh.merge_shards_sum([j for _, j in shards]))


def _compact(res, pkg):
    D, mh = (TD, tmh) if pkg == "port" else (JD, jmh)
    comp = D.compact_from_result(res.llk_ab, res.llk_00, GRID, 0.5)
    return mh.CompactShard(
        barcodes=list(res.barcodes), totl=res.totl, pass_=res.pass_,
        uniq=res.uniq, nsnp=res.nsnp, llks=res.llks, llk0s=res.llk0s,
        compact=comp)


def test_merge_compact_shards_equals_jax():
    shards = _shards(3)
    _assert_same(
        tmh.merge_compact_shards([_compact(t, "port") for t, _ in shards]),
        jmh.merge_compact_shards([_compact(j, "jax") for _, j in shards]))


@pytest.mark.parametrize("gather", ["gather_results", "gather_compact",
                                    "gather_results_sum",
                                    "gather_results_sum_compact"])
def test_gather_with_one_process_is_its_merge(gather):
    """With one process (no process group) each gather returns its merge
    of the one local shard, as the JAX module's does."""
    local, jlocal = _shards(4, n_shards=1)[0]
    if gather == "gather_results":
        got, want = tmh.gather_results(local), jmh.merge_shards([jlocal])
    elif gather == "gather_compact":
        got = tmh.gather_compact(_compact(local, "port"))
        want = jmh.merge_compact_shards([_compact(jlocal, "jax")])
    elif gather == "gather_results_sum":
        got, want = tmh.gather_results_sum(local), jmh.merge_shards_sum(
            [jlocal])
    else:
        got = tmh.gather_results_sum_compact(local, GRID, 0.5,
                                             torch.device("cpu"))
        want = _compact(jmh.merge_shards_sum([jlocal]), "jax")
    assert tmh.process_count() == 1 and tmh.process_index() == 0
    _assert_same(got, want)


# ------------------------------------------------------- two processes
def _workload(tmp_path, case):
    """The BAM/VCF of a two-process case (tests/test_multihost.py's
    inputs): 24 cells on one contig; two contigs of 14 cells each for the
    genome shards; a second contig with reads and no SNP for the empty
    shard."""
    from fixtures import SimRead, random_workload, write_bam, write_vcf

    if case.startswith("genome"):
        parts, contigs = [], []
        for c in range(2):
            cg, names, variants, reads, _ = random_workload(
                random.Random(77 + c), n_cells=14, n_snps=20, n_samples=3,
                reads_per_cell=40, chrom=f"chr{c + 1}")
            contigs.append((f"chr{c + 1}", cg[0][1]))
            parts.append((variants, reads))
        variants = [v for vs, _ in parts for v in vs]
        reads = [r for _, rs in parts for r in rs]
    elif case == "zero_snp_shard":
        cg, names, variants, reads, _ = random_workload(
            random.Random(7), n_cells=10, n_snps=20, n_samples=3,
            reads_per_cell=30, chrom="chr1")
        contigs = [("chr1", cg[0][1]), ("chr2", cg[0][1])]
        for c in range(5):
            reads.append(SimRead("chr2", 100 + c * 10, "ACGTACGTAC",
                                 [30] * 10, cb="BC%05d" % c, ub=f"x{c}"))
        reads.sort(key=lambda r: (r.chrom != "chr1", r.pos0))
    else:
        contigs, names, variants, reads, _ = random_workload(
            random.Random(21), n_cells=24, n_snps=40, n_samples=3,
            reads_per_cell=50)
    vcf = write_vcf(str(tmp_path / "w.vcf"), names, variants,
                    contigs=contigs)
    bam = write_bam(str(tmp_path / "w.bam"), contigs, reads)
    return ["--sam", bam, "--vcf", vcf, "--field", "GT", "--device", "cpu"]


# case: (extra arguments of both runs, extra arguments of the two
# processes, the output files)
CASES = {
    "barcode_exact": ([], [], ()),
    "barcode_fast": (["--mode", "fast"], [], ()),
    "barcode_write_pair": (["--write-pair"], [], (".pair",)),
    "genome": ([], ["--shard-by", "genome"], ()),
    "genome_write_pair": (["--write-pair"], ["--shard-by", "genome"],
                          (".pair",)),
    "zero_snp_shard": ([], ["--shard-by", "genome"], ()),
    "barcode_mesh": ([], ["--mesh", "2x1", "--cell-block", "8"], ()),
}


def _two_processes(base, extra, out):
    """The port CLI as processes 0 and 1 of 2 over gloo on a free
    localhost port, process k writing to out + str(k); returns their
    stderr, after both exit 0."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "demuxlet_tpu_torch.cli"] + base + extra
        + ["--out", out + str(k), "--num-shards", "2", "--shard-id", str(k),
           "--dist-coordinator", f"127.0.0.1:{port}"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=120)
            errs.append(err)
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    return errs


@pytest.mark.parametrize("case", list(CASES))
def test_two_processes_write_what_one_writes(tmp_path, case):
    """Two CLI processes (--num-shards 2 --shard-id k --dist-coordinator
    127.0.0.1:<free port>, gloo) each take their barcode stripe (the
    compact rows through gather_compact; with --write-pair the full
    tensors through gather_results) or genome shard (the summed LLKs
    through gather_results_sum_compact; with --write-pair through
    gather_results_sum), one of them with no SNP, or each a 2x1 mesh; the
    files process 0 writes are byte-identical to the one-process run's,
    .pair included, and process 1 writes none."""
    from demuxlet_tpu_torch import cli

    both, procs_only, extra_files = CASES[case]
    base = _workload(tmp_path, case) + both
    ref = str(tmp_path / "ref")
    assert cli.main(base + ["--out", ref, "--mesh", "none"]) == 0
    dist = str(tmp_path / "dist")
    errs = _two_processes(base, procs_only, dist)
    assert "initialized: process 1 of 2" in errs[1]
    assert "gathered to process 0" in errs[1]
    assert not [f for f in os.listdir(tmp_path) if f.startswith("dist1")]
    for ext in (".single", ".sing2", ".best") + extra_files:
        with open(ref + ext) as fh:
            want = fh.read()
        with open(dist + "0" + ext) as fh:
            got = fh.read()
        assert got == want, f"{case}: {ext} differs\n{errs[0][-1500:]}"
        assert len(want.splitlines()) > 5


def test_two_processes_resume_their_own_spool(tmp_path):
    """--spool with two processes, twice: each process spools its blocks
    under DIR/shard<k>of2 (block files are named by local cell ids, which
    both stripes number from 0: sharing DIR, the second run read the other
    process's blocks and wrote wrong rows, as the JAX CLI still does), and
    the second run, which rewrites no block file, writes what the first
    and one process wrote."""
    from demuxlet_tpu_torch import cli

    base = _workload(tmp_path, "barcode_exact") + ["--cell-block", "8"]
    ref = str(tmp_path / "ref")
    assert cli.main(base + ["--out", ref]) == 0
    spool = str(tmp_path / "spool")

    def blocks():  # block file -> inode: a recomputed block is replaced
        return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_ino
                for d, _, files in os.walk(spool) for f in files}

    _two_processes(base, ["--spool", spool], str(tmp_path / "first"))
    written = blocks()
    _two_processes(base, ["--spool", spool], str(tmp_path / "again"))
    assert blocks() == written and len(written) >= 2
    assert sorted(os.listdir(spool)) == ["shard0of2", "shard1of2"]
    for ext in (".single", ".sing2", ".best"):
        with open(ref + ext) as fh:
            want = fh.read()
        for run in ("first", "again"):
            with open(str(tmp_path / run) + "0" + ext) as fh:
                assert fh.read() == want, (run, ext)


_SUM_COMPACT_WORKER = """
import dataclasses
import sys
import numpy as np
import torch
from demuxlet_tpu_torch.parallel import multihost as mh
rank, port, src, dst = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
mh.initialize(f"127.0.0.1:{port}", 2, rank)
z = np.load(src.format(rank))
local = mh.ShardResult(barcodes=[str(b) for b in z["barcodes"]],
                       **{f: z[f] for f in z.files if f != "barcodes"})
got = mh.gather_results_sum_compact(local, %r, 0.5, torch.device("cpu"))
mh.shutdown()
if rank == 0:
    c = got.compact
    np.savez(dst, barcodes=np.asarray(got.barcodes),
             **{f: getattr(got, f) for f in
                ("totl", "pass_", "uniq", "nsnp", "llks", "llk0s")},
             **{"c_" + f.name: getattr(c, f.name)
                for f in dataclasses.fields(c)})
else:
    assert got is None
"""


def _decided_in_stripes(m, rows):
    """The CompactShard of the merged shard m, decided by the port's
    decide in blocks of `rows` rows in barcode order, the last one padded
    with zero rows: the stripes a gather_results_sum_compact process
    decides, in the order process 0 unpacks them."""
    n = len(m.barcodes)
    pad = lambda x: np.concatenate(
        [x, np.zeros((-n % rows,) + x.shape[1:], x.dtype)])
    ab, a00, llks, llk0s = (torch.from_numpy(pad(x)) for x in
                            (m.llk_ab, m.llk_00, m.llks, m.llk0s))
    dbl_w = torch.as_tensor(TD.doublet_weights(V, GRID, 0.5))
    dbl_msk = torch.as_tensor(TD.doublet_mask(V, A))
    packed = []
    for i in range(0, len(ab), rows):
        sl = slice(i, i + rows)
        out = TD.decide(ab[sl], a00[sl], dbl_w, dbl_msk, 0.5)
        packed.append(TD.pack_rows(out, llks[sl], llk0s[sl]).numpy())
    llks, llk0s, d = TD.unpack_block(np.concatenate(packed)[:n], V, A)
    return tmh.CompactShard(
        barcodes=m.barcodes, totl=m.totl, pass_=m.pass_, uniq=m.uniq,
        nsnp=m.nsnp, llks=llks, llk0s=llk0s, compact=TD.concat([d]))


def test_two_processes_sum_compact_over_several_chunks(tmp_path):
    """gather_results_sum_compact in two processes over gloo, on genome
    shards of 20,000 cells: more than two chunks of the reduce-scatter
    (CH = 2 * RS rows each), the last one partial. Process 0's merge
    equals the port's decide over the same stripes of merge_shards_sum
    of both shards (a sum of two terms commutes), and the JAX
    merge_shards_sum + compact_from_result: identical but for the float
    columns of the decision, within 1e-12 relative (torch's einsum and
    numpy's sum in another order)."""
    shards = _shards(6, n_shards=2, overlap=True, n_cells=20000)
    F = V * V * A + A + V + 1
    CH = 2 * max(16, min(4096, tmh._MAX_CHUNK_BYTES // (2 * F * 8)))
    n = len(set(b for t, _ in shards for b in t.barcodes))
    assert n > 2 * CH
    for k, (t, _) in enumerate(shards):
        np.savez(tmp_path / f"shard{k}.npz",
                 barcodes=np.asarray(t.barcodes),
                 **{f.name: getattr(t, f.name)
                    for f in dataclasses.fields(t) if f.name != "barcodes"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dst = str(tmp_path / "merged.npz")
    worker = _SUM_COMPACT_WORKER % (GRID,)
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(k), str(port),
         str(tmp_path / "shard{}.npz"), dst],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    z = np.load(dst)
    got = tmh.CompactShard(
        barcodes=[str(b) for b in z["barcodes"]],
        **{f: z[f] for f in ("totl", "pass_", "uniq", "nsnp", "llks",
                             "llk0s")},
        compact=TD.CompactResult(
            **{f[2:]: z[f] for f in z.files if f.startswith("c_")}))
    assert len(got.barcodes) == n
    merged = tmh.merge_shards_sum([t for t, _ in shards])
    _assert_same(got, _decided_in_stripes(merged, CH // 2))
    want = _compact(jmh.merge_shards_sum([j for _, j in shards]), "jax")
    for f in dataclasses.fields(want.compact):
        g, w = getattr(got.compact, f.name), getattr(want.compact, f.name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    want.compact = got.compact
    _assert_same(got, want)
