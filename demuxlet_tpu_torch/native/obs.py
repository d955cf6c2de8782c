"""ctypes binding of the engine set-up's native pass over all observations
(``dmx_obs_pass``, native/obs.cpp, built into _prep.so by native/prep.py).

One walk over a pileup's observations gives each cell's distinct-SNP count
(``CsrPileup.n_snps_all``) and the wire code histogram (``choose_cfg``'s
code pass), striped over up to four threads. Absent with the native prep
(no compiler, or DEMUX_TPU_NO_NATIVE_PREP set), and refused on input the
numpy passes would treat otherwise; the caller then runs those passes.
"""

from __future__ import annotations

import ctypes as C

import numpy as np

from demuxlet_tpu_torch.native import prep

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def _lib():
    """The loaded _prep.so with the pass bound, or None."""
    lib = prep._load()
    if lib is None or not hasattr(lib, "dmx_obs_pass"):
        return None
    fn = lib.dmx_obs_pass
    fn.restype = C.c_int
    fn.argtypes = [_I64P, _I32P, _U8P, _U8P, C.c_int64, C.c_int64,
                   C.c_int64, _I64P, _I64P]
    lib.dmx_obs_counts.restype = None
    lib.dmx_obs_counts.argtypes = [C.POINTER(C.c_int64)] * 2
    return lib


def _fits(a, dtype):
    return (isinstance(a, np.ndarray) and a.dtype == dtype
            and a.flags.c_contiguous)


def obs_pass(csr, cap_bq):
    """(nsnp (ncells,) i64, code counts (3 * (cap_bq + 1) + 1,) i64) of
    ``csr`` in one native pass, or None: no library, arrays of another
    form than the CSR pileup's, or input the pass flags (an allele above
    2, a cell_ptr that does not rise from 0 to the observation count, a
    cap_bq outside [0, 255])."""
    lib = _lib()
    if lib is None:
        return None
    ptr, snp = csr.cell_ptr, csr.obs_snp
    al, bq = csr.obs_allele, csr.obs_bq
    n, nobs = csr.nbcs, len(snp)
    if not (0 <= cap_bq <= 255
            and _fits(ptr, np.int64) and _fits(snp, np.int32)
            and _fits(al, np.uint8) and _fits(bq, np.uint8)
            and len(ptr) == n + 1 and len(al) == len(bq) == nobs):
        return None
    nsnp = np.empty(n, dtype=np.int64)
    counts = np.empty(3 * (cap_bq + 1) + 1, dtype=np.int64)
    if lib.dmx_obs_pass(ptr, snp, al, bq, n, nobs, cap_bq, nsnp, counts):
        return None
    return nsnp, counts


def counts():
    """(passes, stripes they used) since the library was loaded, or None
    without the library."""
    lib = _lib()
    if lib is None:
        return None
    calls, stripes = C.c_int64(), C.c_int64()
    lib.dmx_obs_counts(C.byref(calls), C.byref(stripes))
    return calls.value, stripes.value
