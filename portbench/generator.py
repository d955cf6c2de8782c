"""Pooled droplet libraries, made from a seed on a device.

The profile is the repository's realistic end-to-end one: lognormal coverage
per droplet in runs of SNPs inside genes of Zipf popularity, UMIs per slot
1 + Poisson with rare PCR-hot slots, base qualities of two values. Alleles
come from genotypes planted per donor (GT drawn at the pool's allele
frequency): a singlet's from its donor, a doublet's from two donors at its
mixture fraction, an empty droplet's from the whole pool, each observation
with a sequencing error at its base quality. Every seed gets the same set of
coverage targets and mixture fractions (the distributions' quantiles), in
another order, so that seeds change which droplet does what and not how much
work there is.

The arrays come out (cell, SNP)-sorted, as a CSR pileup holds them, so that
set-up never sorts the observations. Everything is drawn with a
``torch.Generator`` on the given device in a few large calls.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

GENE_LEN = 25
RUN_MEAN = 12  # SNPs a gene run covers, on average


@dataclass
class Library:
    """One library: the CSR pileup arrays and what made them."""

    sample_ids: list
    nsnps: int
    barcodes: list
    totl: np.ndarray  # (n,) int64
    pass_: np.ndarray
    uniq: np.ndarray
    cell_ptr: np.ndarray  # (n + 1,) int64
    obs_snp: np.ndarray  # (nobs,) int32, (cell, snp)-sorted
    obs_allele: np.ndarray  # (nobs,) uint8: 0 ref, 1 alt, 2 neither
    obs_bq: np.ndarray  # (nobs,) uint8
    n_slots: int
    n_obs_real: int  # observations of allele 0 or 1
    n_cells: int  # droplets that hold a cell (the rest are empty)
    n_doublets: int

    @property
    def n_barcodes(self) -> int:
        return len(self.barcodes)


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of the run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), *path])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def fixed_sizes(n, profile, device):
    """n coverage targets: the quantiles (i + 1/2) / n of a lognormal of
    median ``profile["median"]`` and log-sd ``profile["sigma"]``, clipped to
    ``profile["clip"]``, ascending."""
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    p = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    z = math.sqrt(2.0) * torch.erfinv(2.0 * p - 1.0)
    lo, hi = profile["clip"]
    s = torch.round(profile["median"] * torch.exp(profile["sigma"] * z))
    return s.clamp(lo, hi).to(torch.int64)


def pool_gps(cfg, seed, device):
    """(gt (NS, V) int64 on ``device``, gps (NS, V, 3) float64 numpy): GT
    drawn per SNP and donor with the configuration's genotype weights, and
    the posteriors a VCF's GT gives under ``geno_error`` (the called
    genotype 1 - e, the others e/2, stored as float32, as the VCF reader
    stores them)."""
    ns, V = cfg["snps"], cfg["donors"]
    g = torch.Generator(device).manual_seed(sub_seed(seed, 0))
    gt = _categorical(cfg["genotype_weights"], ns * V, g, device).view(ns, V)
    err = cfg["geno_error"]
    hi, lo = float(np.float32(1.0 - err)), float(np.float32(err / 2.0))
    gps = torch.full((ns, V, 3), lo, dtype=torch.float64, device=device)
    gps.scatter_(2, gt[:, :, None], hi)
    return gt, gps.cpu().numpy()


def _rand(n, g, device):
    return torch.rand(n, generator=g, device=device, dtype=torch.float64)


def _categorical(p, n, g, device):
    """n draws of the index of weights ``p``."""
    cdf = torch.cumsum(torch.tensor(p, dtype=torch.float64, device=device), 0)
    return torch.searchsorted(cdf / cdf[-1], _rand(n, g, device)).clamp(
        max=len(p) - 1)


def make_library(cfg, traffic, gt, seed, index, device) -> Library:
    """Library ``index`` of the run with ``seed``: ``traffic["cells"]``
    droplets that hold cells and ``traffic["empty"]`` empty ones, in an
    order drawn from the seed, scored against the pool ``gt``."""
    ns, V = cfg["snps"], cfg["donors"]
    g = torch.Generator(device).manual_seed(sub_seed(seed, 1, index))
    n_cells, n_empty = traffic["cells"], traffic.get("empty", 0)
    n = n_cells + n_empty

    def randint(lo, hi, size):
        return torch.randint(lo, hi, (size,), generator=g, device=device)

    def perm(k):
        return torch.randperm(k, generator=g, device=device)

    # which droplets hold cells, and each droplet's coverage target
    order = perm(n)
    is_cell = torch.zeros(n, dtype=torch.bool, device=device)
    is_cell[order[:n_cells]] = True
    cov = torch.empty(n, dtype=torch.int64, device=device)
    cov[order[:n_cells]] = fixed_sizes(
        n_cells, traffic["cell_coverage"], device)[perm(n_cells)]
    if n_empty:
        cov[order[n_cells:]] = fixed_sizes(
            n_empty, traffic["empty_coverage"], device)[perm(n_empty)]

    # gene runs: a droplet of target s draws max(s // 12, 1) genes by Zipf
    # popularity, each a run of 6-18 SNPs from a random start (a one-gene
    # droplet's run is cut to its target); runs in one gene merge
    n_genes = ns // GENE_LEN
    pop = 1.0 / torch.arange(1, n_genes + 1, dtype=torch.float64,
                             device=device) ** traffic["zipf"]
    cdf = torch.cumsum(pop / pop.sum(), 0)
    gene_of_rank = perm(n_genes)
    ng = torch.clamp(cov // RUN_MEAN, min=1)
    draw_cell = torch.repeat_interleave(torch.arange(n, device=device), ng)
    G = draw_cell.numel()
    rank = torch.searchsorted(cdf, _rand(G, g, device)).clamp(max=n_genes - 1)
    gene = gene_of_rank[rank]
    start = randint(0, GENE_LEN - 5, G)
    run = torch.minimum(randint(6, 19, G), GENE_LEN - start)
    one = ng[draw_cell] == 1
    run = torch.where(one, torch.minimum(run, cov[draw_cell]), run)
    first = torch.cumsum(run, 0) - run
    within = torch.arange(int(run.sum()), device=device) \
        - torch.repeat_interleave(first, run)
    snp = torch.repeat_interleave(gene * GENE_LEN + start, run) + within
    key = torch.repeat_interleave(draw_cell, run) * ns + snp
    slots = torch.unique(key)  # sorted: (cell, snp) order
    del draw_cell, rank, gene, start, run, first, within, snp, key
    slot_cell, slot_snp = slots // ns, slots % ns
    S = slots.numel()

    # UMIs per slot
    occ = 1 + torch.poisson(torch.full((S,), traffic["umi_extra_mean"],
                                       dtype=torch.float64, device=device),
                            generator=g).to(torch.int64)
    hot = _rand(S, g, device) < traffic["hot_rate"]
    lo, hi = traffic["hot_extra"]
    occ = occ + torch.where(hot, randint(lo, hi + 1, S), 0)
    cell_o = torch.repeat_interleave(slot_cell, occ)
    snp_o = torch.repeat_interleave(slot_snp, occ)
    N = cell_o.numel()

    # truth: singlets, a fixed count of doublets with fixed mixture
    # fractions (in a drawn order), empty droplets from the pool
    cells = order[:n_cells]
    n_dbl = int(round(traffic["doublet_rate"] * n_cells))
    d1 = randint(0, V, n)
    d2 = (d1 + 1 + randint(0, max(V - 1, 1), n)) % V
    frac = torch.zeros(n, dtype=torch.float64, device=device)
    flo, fhi = traffic["doublet_mix"]
    if n_dbl:
        q = (torch.arange(n_dbl, dtype=torch.float64, device=device) + 0.5) \
            / n_dbl
        frac[cells[perm(n_cells)[:n_dbl]]] = (flo + (fhi - flo) * q)[
            perm(n_dbl)]
    src = torch.where(_rand(N, g, device) < frac[cell_o], d2[cell_o],
                      d1[cell_o])
    src = torch.where(is_cell[cell_o], src, randint(0, V, N))
    geno = gt[snp_o, src]
    allele = (_rand(N, g, device) < geno.to(torch.float64) / 2.0).to(
        torch.int64)
    vals = torch.tensor(traffic["bq"]["values"], device=device)
    bq = vals[_categorical(traffic["bq"]["p"], N, g, device)]
    erred = _rand(N, g, device) < torch.pow(10.0, -bq.to(torch.float64) / 10)
    u = _rand(N, g, device)
    allele = torch.where(erred & (u < 1.0 / 3.0), 1 - allele, allele)
    allele = torch.where(erred & (u >= 1.0 / 3.0), 2, allele)

    uniq = torch.bincount(cell_o, minlength=n)
    rd = traffic["reads"]
    pass_ = uniq + torch.poisson(rd["dup_per_umi"] * uniq.to(torch.float64),
                                 generator=g).to(torch.int64)
    totl = pass_ + torch.poisson(rd["filtered_per_read"]
                                 * pass_.to(torch.float64),
                                 generator=g).to(torch.int64)
    cell_ptr = torch.zeros(n + 1, dtype=torch.int64, device=device)
    cell_ptr[1:] = torch.cumsum(uniq, 0)

    rng = np.random.default_rng(sub_seed(seed, 2, index))
    code = rng.choice(4 ** 16, size=n, replace=False)
    digits = (code[:, None] >> (2 * np.arange(15, -1, -1))) & 3
    letters = np.array(list("ACGT"))[digits]
    barcodes = ["".join(r) + "-1" for r in letters.tolist()]

    return Library(
        sample_ids=["DONOR%02d" % j for j in range(V)],
        nsnps=ns,
        barcodes=barcodes,
        totl=totl.cpu().numpy(),
        pass_=pass_.cpu().numpy(),
        uniq=uniq.cpu().numpy(),
        cell_ptr=cell_ptr.cpu().numpy(),
        obs_snp=snp_o.to(torch.int32).cpu().numpy(),
        obs_allele=allele.to(torch.uint8).cpu().numpy(),
        obs_bq=bq.to(torch.uint8).cpu().numpy(),
        n_slots=S,
        n_obs_real=int((allele < 2).sum()),
        n_cells=n_cells,
        n_doublets=n_dbl,
    )
