"""The engine set-up's native pass over all observations (native/obs.cpp,
``CsrPileup.obs_pass``) against the two numpy passes it stands for
(``CsrPileup._n_snps_all_impl`` and ``choose_cfg``'s bincount pass): the same
distinct-SNP counts, the same code histogram and so the same ``WireCfg``,
also the JAX package's; on empty pileups and cells, cells of allele 2
alone, base qualities above the cap, caps 40 and 126, and one to four
stripes, an empty stripe among them. The pass counter shows the stripes
each pass used. Input the numpy passes would treat otherwise is refused,
and without the native prep both caches stay empty."""

import dataclasses

import numpy as np
import pytest

from demuxlet_tpu_torch.host import wire as TW
from demuxlet_tpu_torch.host.csr import CsrPileup
from demuxlet_tpu_torch.native import obs
from demuxlet_tpu_torch.native import prep

# observations a stripe, as native/obs.cpp has it
OBS_PER_STRIPE = 1 << 18
BIG = 3 * OBS_PER_STRIPE + 5  # four stripes


def _csr(seed, per_cell, alleles=(0, 1, 2), bq_hi=41, snps_per=None):
    """A pileup of len(per_cell) cells of per_cell[c] observations each,
    (cell, snp)-sorted: each observation a new SNP with chance 0.45 (or
    every snps_per-th), each cell from SNP 5, alleles drawn from
    ``alleles`` and base qualities from [0, bq_hi)."""
    rng = np.random.default_rng(seed)
    per_cell = np.asarray(per_cell, dtype=np.int64)
    n, nobs = len(per_cell), int(per_cell.sum())
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(per_cell, out=ptr[1:])
    # snp ids rise within a cell, by 0 (same SNP) or more; each cell
    # starts anew, so a cell's first SNP may repeat the last one's
    step = (rng.random(nobs) < 0.45) if snps_per is None \
        else (np.arange(nobs) % snps_per == 0)
    snp = np.cumsum(step * rng.integers(1, 9, size=nobs))
    full = per_cell > 0
    snp -= np.repeat(snp[ptr[:-1][full]], per_cell[full]) - 5
    z = np.zeros(n, dtype=np.int64)
    return CsrPileup(
        sample_ids=["S0", "S1"], nsnps=int(snp.max(initial=0)) + 1,
        barcodes=["B%07d" % i for i in range(n)], cell_totl=z, cell_pass=z,
        cell_uniq=z, cell_ptr=ptr, obs_snp=snp.astype(np.int32),
        obs_allele=rng.choice(np.asarray(alleles, np.uint8), size=nobs),
        obs_bq=rng.integers(0, bq_hi, size=nobs).astype(np.uint8))


def _fresh(csr):
    """The same arrays in a pileup with empty caches."""
    return dataclasses.replace(csr)


def _codes(csr, cap):
    """The code histogram, counted plainly."""
    nq = cap + 1
    code = csr.obs_allele.astype(np.int64) * nq + np.minimum(csr.obs_bq, cap)
    return np.bincount(code, minlength=3 * nq + 1)


def _stripes(nobs):
    return min(4, max(1, -(-nobs // OBS_PER_STRIPE)))


CASES = {
    # name: (cells' observation counts, _csr keywords, cap_bq)
    "empty_pileup": ([], {}, 40),
    "cells_without_observations": ([0, 0, 0], {}, 40),
    "one_observation": ([1], {}, 40),
    "empty_first_last_and_runs": ([0, 0, 7, 0, 0, 0, 12, 1, 0, 3, 0, 0],
                                  {}, 40),
    "allele2_alone": ([5, 9, 0, 4], dict(alleles=(2,)), 40),
    "bq_above_cap40": ([30] * 50, dict(bq_hi=256), 40),
    "bq_above_cap126": ([30] * 50, dict(bq_hi=256), 126),
    "cap126": ([30] * 50, dict(bq_hi=127), 126),
    "one_snp_a_cell": ([4, 4, 4], dict(snps_per=10 ** 9), 40),
    "two_stripes_7_cells": ([OBS_PER_STRIPE // 5] * 7, {}, 40),
    "three_stripes_5_cells": ([2 * OBS_PER_STRIPE // 5 + 3] * 5, {}, 40),
    "four_stripes_7_cells": ([BIG // 7 + 1] * 7, dict(bq_hi=256), 126),
    "four_stripes_many_cells": ([BIG // 1001 + 1] * 1001, {}, 40),
    "empty_stripes": ([10, BIG, 0, 10], {}, 40),
    "empty_stripe_at_end": ([BIG, 0, 0], {}, 40),
}


@pytest.fixture
def native():
    if obs.counts() is None:
        pytest.skip("native prep not built")


@pytest.mark.parametrize("name", list(CASES))
def test_pass_equals_numpy_passes(native, name):
    """The native pass's counts and histogram equal the numpy passes';
    choose_cfg gives the same WireCfg on either; the pass used
    ceil(observations / 2^18) stripes, at most four."""
    per_cell, kw, cap = CASES[name]
    csr = _csr(len(name), per_cell, **kw)
    before = obs.counts()
    assert csr.obs_pass(cap)
    calls, stripes = obs.counts()
    assert (calls, stripes) == (before[0] + 1,
                                before[1] + _stripes(len(csr.obs_snp)))
    ref = _fresh(csr)
    want_nsnp = ref._n_snps_all_impl()
    got_nsnp = csr.n_snps_all()
    assert got_nsnp.dtype == want_nsnp.dtype == np.int64
    np.testing.assert_array_equal(got_nsnp, want_nsnp)
    np.testing.assert_array_equal(csr.code_hist(cap), _codes(ref, cap))
    assert ref.code_hist(cap) is None
    assert TW.choose_cfg(csr, cap) == TW.choose_cfg(ref, cap)
    assert obs.counts() == (calls, stripes)  # both read the caches
    if name == "allele2_alone":
        assert TW.choose_cfg(csr, cap).dict_codes == ()


def test_wire_cfg_equals_jax_package(native):
    """With the native pass's histogram cached, the port's choose_cfg
    equals the JAX package's numpy one."""
    from demuxlet_tpu.host import wire as jw
    from test_torch_engine import _pcr_hot_csr

    jcsr, _ = _pcr_hot_csr(9, n_cells=40)
    csr = CsrPileup(**{f.name: getattr(jcsr, f.name)
                       for f in dataclasses.fields(CsrPileup)})
    assert csr.obs_pass(40) and csr.code_hist(40) is not None
    assert (dataclasses.astuple(TW.choose_cfg(csr, 40))
            == dataclasses.astuple(jw.choose_cfg(jcsr, 40)))


@pytest.mark.parametrize("fault", ["allele3", "ptr_short", "ptr_falls",
                                   "cap256", "cap_negative"])
def test_refused_input_fills_no_cache(native, fault):
    """Input the numpy passes would treat otherwise is refused, whole:
    obs_pass is False and neither cache is filled."""
    csr, cap = _csr(3, [6, 8, 5]), 40
    if fault == "allele3":
        csr.obs_allele[9] = 3
    elif fault == "ptr_short":
        csr.cell_ptr[-1] -= 1
    elif fault == "ptr_falls":
        csr.cell_ptr[1], csr.cell_ptr[2] = csr.cell_ptr[2], csr.cell_ptr[1]
    else:
        cap = 256 if fault == "cap256" else -1
    assert not csr.obs_pass(cap)
    assert csr.code_hist(cap) is None
    assert getattr(csr, "_nsnp_cache", None) is None


def test_without_native_prep_numpy_passes_run(monkeypatch):
    """DEMUX_TPU_NO_NATIVE_PREP: obs_pass fills nothing, and the numpy
    passes give the counts and the WireCfg the native pass gives."""
    csr = _csr(5, [40] * 300 + [0, 3])
    native = obs.obs_pass(csr, 40)
    monkeypatch.setenv("DEMUX_TPU_NO_NATIVE_PREP", "1")
    monkeypatch.setattr(prep, "_LIB", None)
    monkeypatch.setattr(prep, "_LOAD_FAILED", False)
    assert obs.counts() is None
    assert not csr.obs_pass(40) and csr.code_hist(40) is None
    cfg = TW.choose_cfg(csr, 40)
    nsnp = csr.n_snps_all()
    if native is None:
        pytest.skip("native prep not built")
    np.testing.assert_array_equal(nsnp, native[0])
    np.testing.assert_array_equal(_codes(csr, 40), native[1])
    monkeypatch.undo()
    fast = _fresh(csr)
    assert fast.obs_pass(40)
    assert TW.choose_cfg(fast, 40) == cfg
