"""The port's multi-process merges (``demuxlet_tpu_torch/parallel/
multihost.py``) on the CPU: the copied helpers and merges against the JAX
module's on the same seeded shards, the ingest's barcode stripe against
the JAX owns_barcode, each gather with one process against its merge,
gather_results_sum_compact over several chunks in two processes, the
reduce-scatter's route rule and its host route in two and three
processes on the CPU, and two,
three and four CLI processes joined over gloo on localhost, whose process
0 writes what one process writes, as tests/test_multihost.py holds the
JAX CLI; and two port processes against two JAX CLI processes on the same
BAM/VCF."""

import dataclasses
import os
import random
import socket
import subprocess
import sys
import time
import types

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
    """The BAM/VCF of a multi-process case (tests/test_multihost.py's
    inputs): 24 cells on one contig (27 of seed 43 for three processes);
    two contigs of 14 cells each for the genome shards (15 of seeds 87 and
    88 for four processes); a second contig with reads and no SNP for the
    empty shard."""
    from fixtures import SimRead, random_workload, write_bam, write_vcf

    if case.startswith("genome"):
        seed, cells, snps = (87, 15, 24) if case == "genome_p4" else (
            77, 14, 20)
        parts, contigs = [], []
        for c in range(2):
            cg, names, variants, reads, _ = random_workload(
                random.Random(seed + c), n_cells=cells, n_snps=snps,
                n_samples=3, reads_per_cell=40, chrom=f"chr{c + 1}")
            contigs.append((f"chr{c + 1}", cg[0][1]))
            parts.append((variants, reads))
        variants = [v for vs, _ in parts for v in vs]
        reads = [r for _, rs in parts for r in rs]
    elif case == "barcode_p3":
        contigs, names, variants, reads, _ = random_workload(
            random.Random(43), n_cells=27, n_snps=40, n_samples=3,
            reads_per_cell=50)
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


def _processes(n, base, extra, out, module="demuxlet_tpu_torch.cli",
               env=None, timeout=120):
    """A CLI (the port's, or the JAX package's with env) as processes 0..n-1
    of n on a free localhost port, process k writing to out + str(k), each
    with OMP_NUM_THREADS=2; returns their stderr, after all exit 0. The
    port comes from a bind to port 0 and its release, so another process
    can take it first: then the run is made once more on a fresh port.
    Output goes to files, so no pipe fills while a peer waits in a
    collective; a process that fails ends the others."""
    env = dict(os.environ if env is None else env, OMP_NUM_THREADS="2")
    for attempt in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        logs = [open(f"{out}.stderr{k}", "w+") for k in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", module] + base + extra
            + ["--out", out + str(k), "--num-shards", str(n), "--shard-id",
               str(k), "--dist-coordinator", f"127.0.0.1:{port}"],
            env=env, stdout=subprocess.DEVNULL, stderr=log, text=True)
            for k, log in enumerate(logs)]
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs) and not any(
                    p.poll() for p in procs) and time.monotonic() < deadline:
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait(timeout=30)
        errs = []
        for log in logs:
            log.seek(0)
            errs.append(log.read())
            log.close()
        taken = any("EADDRINUSE" in e or "ddress already in use" in e
                    for e in errs)
        if attempt or not taken or not any(p.returncode for p in procs):
            break
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
    errs = _processes(2, base, procs_only, dist)
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


def _read(prefix, ext):
    with open(prefix + ext) as fh:
        return fh.read()


def test_three_processes_barcode_stripes_write_what_one_writes(tmp_path):
    """P=3 barcode stripes (tests/test_multihost.py's P=3 case, on its
    inputs, exact): every barcode's rows are computed whole by the process
    that owns it, so process 0's .single, .sing2 and .best are
    byte-identical to one process's, and processes 1 and 2 write none."""
    from demuxlet_tpu_torch import cli

    base = _workload(tmp_path, "barcode_p3") + ["--mesh", "none"]
    ref = str(tmp_path / "ref")
    assert cli.main(base + ["--out", ref]) == 0
    dist = str(tmp_path / "dist")
    errs = _processes(3, base, [], dist)
    assert all("gathered to process 0" in e for e in errs[1:])
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith(("dist1.", "dist2."))]
    for ext in (".single", ".sing2", ".best"):
        want = _read(ref, ext)
        assert _read(dist + "0", ext) == want, f"P=3 {ext} differs"
        assert len(want.splitlines()) > 20


def _render_quantum(s: str) -> float:
    """Smallest rendered step of a printf-formatted number: one unit in
    the last printed decimal (fixed) or significant (e-notation) digit."""
    s = s.strip()
    if "e" in s or "E" in s:
        mant, _, exp = s.lower().partition("e")
        dec = len(mant.split(".")[1]) if "." in mant else 0
        return 10.0 ** (int(exp) - dec)
    dec = len(s.split(".")[1]) if "." in s else 0
    return 10.0 ** (-dec)


def _assert_rows_close(want_line: str, got_line: str, ctx):
    """Rendered rows equal up to 1.5 rendering quanta per float field: the
    P-way shard sum's last-bit reordering may move a printed digit, a
    merge fault (a shard's contribution lost or doubled) moves many."""
    cw, cg = want_line.split("\t"), got_line.split("\t")
    assert len(cw) == len(cg), ctx
    for a, b in zip(cw, cg):
        if a == b:
            continue
        fa, fb = float(a), float(b)  # a mismatch that is not a float fails
        tol = 1.5 * max(_render_quantum(a), _render_quantum(b))
        assert abs(fa - fb) <= tol, (ctx, a, b, tol)


def test_four_processes_genome_shards_match_one(tmp_path):
    """P=4 genome shards (tests/test_multihost.py's P=4 case, on its
    two-contig inputs, exact): each process sums its quarter of the genome
    into the reduce-scatter of gather_results_sum_compact, so the LLKs add
    in another order than one process's. Calls and ids (columns 0, 5, 6,
    8, 11 and 12 of .best after canonicalize_best) equal one process's;
    every other field of .single, .sing2 and .best within 1.5 rendering
    quanta."""
    from parity_utils import canonicalize_best

    from demuxlet_tpu_torch import cli

    base = _workload(tmp_path, "genome_p4") + ["--mesh", "none"]
    ref = str(tmp_path / "ref")
    assert cli.main(base + ["--out", ref]) == 0
    dist = str(tmp_path / "dist")
    errs = _processes(4, base, ["--shard-by", "genome"], dist)
    assert "initialized: process 3 of 4" in errs[3]
    for ext in (".single", ".sing2", ".best"):
        want = _read(ref, ext).splitlines()
        got = _read(dist + "0", ext).splitlines()
        if ext == ".best":
            want, got = canonicalize_best(want), canonicalize_best(got)
        assert len(want) == len(got) > 10, (ext, errs[0][-1500:])
        for lw, lg in zip(want, got):
            if lw == lg:
                continue
            if ext == ".best":
                cw, cg = lw.split("\t"), lg.split("\t")
                for col in (0, 5, 6, 8, 11, 12):
                    assert cw[col] == cg[col], (ext, lw, lg)
            _assert_rows_close(lw, lg, (ext, lw[:60]))


def _jax_env():
    """The environment of a JAX CLI process as tests/test_multihost.py
    gives it (CPU, x64, one host device), XLA's CPU work on one thread."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_X64"] = "true"
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=1 "
                        "--xla_cpu_multi_thread_eigen=false")
    return env


@pytest.mark.parametrize("case", ["barcode_exact", "genome"])
def test_two_processes_match_two_jax_processes(tmp_path, case):
    """Two port CLI processes over gloo against two JAX CLI processes over
    jax.distributed, on the same BAM/VCF in exact mode, barcode stripes
    (gather_compact) or genome shards (gather_results_sum_compact):
    process 0's .single and .sing2 byte-identical, .best equal after
    canonicalize_best."""
    from parity_utils import canonicalize_best

    both, procs_only, _ = CASES[case]
    base = _workload(tmp_path, case) + both + ["--mesh", "none"]
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    _processes(2, base, procs_only, jax, module="demuxlet_tpu.cli",
               env=_jax_env(), timeout=300)
    _processes(2, base, procs_only, port)
    for ext in (".single", ".sing2"):
        want = _read(jax + "0", ext)
        assert _read(port + "0", ext) == want, f"{case}: {ext} differs"
        assert len(want.splitlines()) > 20
    assert canonicalize_best(_read(port + "0", ".best").splitlines()) == \
        canonicalize_best(_read(jax + "0", ".best").splitlines())


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

    _processes(2, base, ["--spool", spool], str(tmp_path / "first"))
    written = blocks()
    _processes(2, base, ["--spool", spool], str(tmp_path / "again"))
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


# ------------------------------------------------ the reduce-scatter route
@pytest.mark.parametrize("hostids,uuids,route", [
    # one card per process: two cards of one host, or one card that
    # distinct NCCL_HOSTIDs show NCCL as two hosts' cards
    ((None, None), ("GPU-0", "GPU-1"), "nccl"),
    (("node0", "node1"), ("GPU-0", "GPU-0"), "nccl"),
    ((None, None, None), ("GPU-0", "GPU-1", "GPU-2"), "nccl"),
    # two processes on one card, seen as NCCL sees them
    ((None, None), ("GPU-0", "GPU-0"), "host"),
    (("node0", "node0"), ("GPU-0", "GPU-0"), "host"),
    ((None, None, None), ("GPU-0", "GPU-1", "GPU-0"), "host"),
    # any process on the CPU
    ((None, None), (None, "GPU-0"), "host"),
    ((None, None), (None, None), "host"),
])
def test_merge_route_rule(monkeypatch, hostids, uuids, route):
    """merge_route of the processes' merge_keys: "nccl" exactly when every
    process drives a card and no two share a key (the host, NCCL_HOSTID
    where set, and the card's UUID); each key as merge_key makes it in
    that process's environment."""
    keys = []
    for hostid, uuid in zip(hostids, uuids):
        if hostid is None:
            monkeypatch.delenv("NCCL_HOSTID", raising=False)
        else:
            monkeypatch.setenv("NCCL_HOSTID", hostid)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev, u=uuid: types.SimpleNamespace(uuid=u))
        keys.append(tmh.merge_key(
            torch.device("cpu") if uuid is None else torch.device("cuda", 0)))
    if uuids[0] is not None and hostids[0] is None:
        assert keys[0] == f"{socket.gethostname()}/{uuids[0]}"
    assert tmh.merge_key(None) == "cpu"
    assert tmh.merge_route(keys) == route


_ROUTE_WORKER = """
import dataclasses
import sys
import numpy as np
import torch
from demuxlet_tpu_torch.parallel import multihost as mh
rank, n, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
src, dst = sys.argv[4], sys.argv[5]
mh.initialize(f"127.0.0.1:{port}", n, rank, device=torch.device("cpu"))
assert mh.current_route() == "host", mh.current_route()
z = np.load(src.format(rank))
local = mh.ShardResult(barcodes=[str(b) for b in z["barcodes"]],
                       **{f: z[f] for f in z.files if f != "barcodes"})
got = mh.gather_results_sum_compact(local, %r, 0.5, torch.device("cpu"))
mh.shutdown()
assert mh.current_route() == "host"
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


@pytest.mark.parametrize("n_procs", [2, 3])
def test_processes_on_the_cpu_reduce_on_the_host_route(tmp_path, n_procs):
    """gather_results_sum_compact in 2 and 3 processes that initialize on
    the CPU: the route is "host" (every merge key is "cpu"), the one code
    path reduces on the CPU as the route's device, and process 0's merge
    equals the JAX merge_shards_sum + compact_from_result of the same
    genome shards (calls, ids and counters exact, the decision's floats
    within 1e-12 relative); at P=2 it equals, bit for bit, the port's
    decide over the same stripes of merge_shards_sum."""
    shards = _shards(9, n_shards=n_procs, overlap=True, n_cells=60)
    for k, (t, _) in enumerate(shards):
        np.savez(tmp_path / f"shard{k}.npz",
                 barcodes=np.asarray(t.barcodes),
                 **{f.name: getattr(t, f.name)
                    for f in dataclasses.fields(t) if f.name != "barcodes"})
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dst = str(tmp_path / "merged.npz")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ROUTE_WORKER % (GRID,), str(k),
         str(n_procs), str(port), str(tmp_path / "shard{}.npz"), dst],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for k in range(n_procs)]
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
    if n_procs == 2:
        merged = tmh.merge_shards_sum([t for t, _ in shards])
        F = V * V * A + A + V + 1
        _assert_same(got, _decided_in_stripes(
            merged, tmh.stripe_rows(n_procs, F)))
    want = _compact(jmh.merge_shards_sum([j for _, j in shards]), "jax")
    for f in ("llks", "llk0s"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-12, atol=0, err_msg=f)
    for f in dataclasses.fields(want.compact):
        g, w = getattr(got.compact, f.name), getattr(want.compact, f.name)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0,
                                       err_msg=f.name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    want.compact, want.llks, want.llk0s = got.compact, got.llks, got.llk0s
    _assert_same(got, want)
