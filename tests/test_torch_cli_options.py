"""The port CLI against the JAX CLI, one case per input option, on the
CPU: tests/test_e2e.py's workload (seed 7, 25 cells, 50 SNPs, 3 samples,
60 reads a cell) with GP and PL written from the planted genotypes, as
tests/test_golden_reference.py writes them. Both CLIs run in this process
with --device cpu. Exact mode: .single and .sing2 byte-identical, .best
equal after canonicalize_best. Fast mode: equal .best calls, every LLK
column of .best within 2e-5 relative (scale max(1, |x|))."""

import gzip
import os
import random

import pytest
import torch

torch.set_num_threads(2)

FAST_TOL = 2e-5  # fast-mode contract, relative with scale max(1, |x|)


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    """The BAM/VCF (GT, GP and PL), a --group-list file of 12 of the 25
    barcodes and a --sm-list file of two samples; the arguments both CLIs
    share."""
    from fixtures import random_workload, write_bam, write_vcf

    tmp = tmp_path_factory.mktemp("cli_options")
    contigs, names, variants, reads, truth = random_workload(
        random.Random(7), n_cells=25, n_snps=50, n_samples=3,
        reads_per_cell=60)
    for v in variants:
        for s in v.samples:
            g = {"0/0": 0, "0/1": 1, "1/1": 2}[s["GT"]]
            gp = [0.02, 0.02, 0.02]
            gp[g] = 0.96
            s["GP"] = ",".join(f"{x:g}" for x in gp)
            pl = [60, 60, 60]
            pl[g] = 0
            s["PL"] = ",".join(str(x) for x in pl)
    vcf = write_vcf(str(tmp / "w.vcf.gz"), names, variants, contigs=contigs,
                    fmt_keys=["GT", "GP", "PL"])
    bam = write_bam(str(tmp / "w.bam"), contigs, reads)
    barcodes = sorted(truth)
    assert len(barcodes) == 25
    with open(tmp / "groups.txt", "w") as fh:
        fh.write("".join(b + "\n" for b in barcodes[::2][:12]))
    with open(tmp / "samples.txt", "w") as fh:
        fh.write(f"{names[1]}\n{names[2]}\n")
    base = ["--sam", bam, "--vcf", vcf, "--device", "cpu", "--mesh", "none"]
    return tmp, base, names


# case: (arguments, mode); {tmp} and {S0}.. are filled in from the workload
CASES = {
    "group_list": (["--field", "GT", "--group-list", "{tmp}/groups.txt"],
                   "exact"),
    "sm": (["--field", "GT", "--sm", "{S2}", "--sm", "{S0}"], "exact"),
    "sm_list": (["--field", "GT", "--sm-list", "{tmp}/samples.txt"],
                "exact"),
    "doublet_prior": (["--field", "GT", "--doublet-prior", "0.3", "--alpha",
                       "0", "--alpha", "0.25", "--alpha", "0.5"], "exact"),
    "field_gp": (["--field", "GP"], "exact"),
    "field_pl": (["--field", "PL"], "exact"),
    "min_counts": (["--field", "GT", "--min-total", "40", "--min-uniq", "20",
                    "--min-snp", "10"], "exact"),
    # the thresholds above keep every cell of this workload (60 reads, 125+
    # unique, 42+ SNPs a cell); these drop some
    "min_counts_drop": (["--field", "GT", "--min-uniq", "133", "--min-snp",
                         "44"], "exact"),
    "alpha_0": (["--field", "GT", "--alpha", "0"], "exact"),
    "geno_error": (["--field", "GT", "--geno-error", "0.05", "--min-mac",
                    "2"], "exact"),
    "read_filters": (["--field", "GT", "--cap-BQ", "30", "--min-BQ", "20",
                      "--min-MQ", "30"], "exact"),
    "gz_outputs": (["--field", "GT"], "exact"),
    "fast_gp": (["--mode", "fast", "--field", "GP"], "fast"),
}


def _outputs(prefix):
    """The .single, .sing2 and .best lines of a run, BGZF outputs
    decompressed (a prefix ending in .gz writes x.single.gz etc.)."""
    out = {}
    for ext in (".single", ".sing2", ".best"):
        if prefix.endswith(".gz"):
            with gzip.open(prefix[:-3] + ext + ".gz", "rt") as fh:
                out[ext] = fh.read().splitlines()
        else:
            with open(prefix + ext) as fh:
                out[ext] = fh.read().splitlines()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax_cli(workload, case):
    """One input option through the port CLI and the JAX CLI on the same
    BAM/VCF: the exact-mode or fast-mode contract holds, and the option
    took effect (rows dropped, samples restricted or outputs compressed
    where it says so)."""
    from parity_utils import canonicalize_best, canonicalize_best_line

    from demuxlet_tpu import cli as jcli
    from demuxlet_tpu_torch import cli as tcli

    tmp, base, names = workload
    args, mode = CASES[case]
    fill = dict(tmp=str(tmp), **{f"S{i}": n for i, n in enumerate(names)})
    args = [a.format(**fill) for a in args]
    gz = ".gz" if case == "gz_outputs" else ""
    files = {}
    for pkg, main in (("port", tcli.main), ("jax", jcli.main)):
        prefix = str(tmp / f"{case}_{pkg}") + gz
        assert main(base + args + ["--out", prefix]) == 0
        files[pkg] = _outputs(prefix)
    got, want = files["port"], files["jax"]
    assert len(want[".best"]) > 5
    if case == "gz_outputs":
        assert not os.path.exists(str(tmp / "gz_outputs_port.best"))
    if case in ("group_list", "min_counts_drop"):
        assert len(want[".best"]) < 26
    if case in ("sm", "sm_list"):
        kept = {names[0], names[2]} if case == "sm" else set(names[1:])
        assert {l.split("\t")[1] for l in want[".single"][1:]} == kept
    if mode == "exact":
        assert got[".single"] == want[".single"]
        assert got[".sing2"] == want[".sing2"]
        assert canonicalize_best(got[".best"]) == canonicalize_best(
            want[".best"])
        return
    header = want[".best"][0].split("\t")
    llk_cols = [i for i, h in enumerate(header) if "LLK" in h]
    assert got[".best"][0] == want[".best"][0] and len(llk_cols) == 9
    assert len(got[".best"]) == len(want[".best"])
    for lg, lw in zip(got[".best"][1:], want[".best"][1:]):
        cg = canonicalize_best_line(lg).split("\t")
        cw = canonicalize_best_line(lw).split("\t")
        assert cg[5] == cw[5], (cg[0], cg[5], cw[5])
        for i in llk_cols:
            x, y = float(cg[i]), float(cw[i])
            assert abs(x - y) <= FAST_TOL * max(1.0, abs(y)), (
                cg[0], header[i], x, y)
