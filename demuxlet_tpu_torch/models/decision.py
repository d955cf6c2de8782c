"""Device-side decision pass (port of ``demuxlet_tpu/models/decision.py``).

``decide``, ``compact_step_body`` and ``compact_step_body_exact`` run in
torch float64 on the block's device and keep the packed (B, 2V+A+11) f64
row layout, so ``unpack_block`` and the shared renderer
(``models/outputs.py`` ``write_pass2_compact``) work unchanged.
Semantics: first-occurrence argmaxes (``torch.argmax`` returns the first
maximum), the -1e300-seeded second best, -inf masking of excluded doublet
channels.

``CompactResult``, ``doublet_weights``, ``doublet_mask``, ``take``,
``concat``, ``_PACK_KEYS``, ``unpack_block`` and ``compact_from_result``
(numpy, for ``run()``'s full tensors) are copies of the JAX
module's JAX-free helpers (that module imports JAX at the top);
tests/test_torch_decision.py pins each copy equal to the original.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from demuxlet_tpu_torch.ops.front import front_half, pair_half
from demuxlet_tpu_torch.ops.front_exact import (
    exact_front,
    exact_pair,
    front_exact,
)
from demuxlet_tpu_torch.ops.pair import pair_llks
from demuxlet_tpu_torch.ops.pair_exact import pair_exact
from demuxlet_tpu_torch.utils.spans import span


@dataclass
class CompactResult:
    """Per-cell decision outputs (numpy, trimmed to real cells)."""

    sing_col: np.ndarray  # (n, V)   llkAB[j,0,0]
    llk_00: np.ndarray  # (n, A)
    max_llk: np.ndarray  # (n,)
    sum_single: np.ndarray  # (n,)
    sum_double: np.ndarray  # (n,)
    i_sing1: np.ndarray  # (n,) int
    i_sing2: np.ndarray  # (n,) int
    max_sing2: np.ndarray  # (n,)  second-best value (seeded -1e300)
    best_flat: np.ndarray  # (n,) int flat (j,k,a) argmax over doublet mask
    pair_llk12: np.ndarray  # (n,)
    pair_llk10: np.ndarray  # (n,)  llkAB[j_best, 0, a_best] (reference quirk)
    pair_llk20: np.ndarray  # (n,)  llkAB[k_best, 0, a_best]


def doublet_weights(nv: int, grid_alpha: Sequence[float], doublet_prior: float):
    """(V,V,A) posterior weights of cmd_cram_demuxlet.cpp:724-734."""
    na = len(grid_alpha)
    w = np.zeros((nv, nv, na))
    if nv > 1 and na > 1:
        for n in range(1, na):
            w[:, :, n] = (
                doublet_prior
                / nv
                / (nv - 1)
                / (na - 1)
                / (2.0 if grid_alpha[n] == 0.5 else 1.0)
            )
        for j in range(nv):
            w[j, j, :] = 0.0
    return w


def doublet_mask(nv: int, na: int) -> np.ndarray:
    """(V,V,A) bool argmax mask: j != k, alpha index >= 1 (:799-814) —
    independent of the posterior weights (which can be all-zero)."""
    m = np.ones((nv, nv, na), dtype=bool)
    for j in range(nv):
        m[j, j, :] = False
    m[:, :, 0] = False
    return m


def take(res: CompactResult, idx: np.ndarray) -> CompactResult:
    """Reindex every per-cell field (row i of the result <- row idx[i]);
    used to undo the engine's coverage-sorted block permutation."""
    return CompactResult(**{
        f.name: getattr(res, f.name)[idx]
        for f in dataclasses.fields(CompactResult)
    })


def concat(parts: Sequence[dict]) -> CompactResult:
    cat = lambda k: np.concatenate([p[k] for p in parts])
    return CompactResult(
        sing_col=cat("sing_col").astype(np.float64),
        llk_00=cat("llk_00").astype(np.float64),
        max_llk=cat("max_llk").astype(np.float64),
        sum_single=cat("sum_single").astype(np.float64),
        sum_double=cat("sum_double").astype(np.float64),
        i_sing1=cat("i_sing1").astype(np.int64),
        i_sing2=cat("i_sing2").astype(np.int64),
        max_sing2=cat("max_sing2").astype(np.float64),
        best_flat=cat("best_flat").astype(np.int64),
        pair_llk12=cat("pair_llk12").astype(np.float64),
        pair_llk10=cat("pair_llk10").astype(np.float64),
        pair_llk20=cat("pair_llk20").astype(np.float64),
    )


_PACK_KEYS = (
    "max_llk", "sum_single", "sum_double", "i_sing1", "i_sing2",
    "max_sing2", "best_flat", "pair_llk12", "pair_llk10", "pair_llk20",
)


def unpack_block(packed: np.ndarray, n_samples: int, n_alpha: int):
    """Split the packed (m, 2V+A+11) array back into (llks, llk0s, dict)."""
    V, A = n_samples, n_alpha
    o = 0
    out = {}
    out["sing_col"] = packed[:, o : o + V]; o += V
    out["llk_00"] = packed[:, o : o + A]; o += A
    for k in _PACK_KEYS:
        out[k] = packed[:, o]; o += 1
    llks = packed[:, o : o + V]; o += V
    llk0s = packed[:, o]; o += 1
    return llks, llk0s, out


def compact_from_result(
    llk_ab: np.ndarray,
    llk_00: np.ndarray,
    grid_alpha: Sequence[float],
    doublet_prior: float,
) -> CompactResult:
    """Build a CompactResult from full (n,V,V,A) LLKs (exact-mode path):
    the same decision pass the fast path fuses on device, run once over
    host-resident f64 arrays. Used to gather compact rows (not the full
    tensor) across hosts (parallel/multihost.gather_compact)."""
    llk_ab = np.asarray(llk_ab, dtype=np.float64)
    llk_00 = np.asarray(llk_00, dtype=np.float64)
    n, V, _, A = llk_ab.shape
    dbl_w = doublet_weights(V, grid_alpha, doublet_prior)
    dbl_msk = doublet_mask(V, A)
    rows = np.arange(n)
    flat = llk_ab.reshape(n, -1)
    max_llk = np.maximum(
        flat.max(axis=1) if flat.shape[1] else np.full(n, -np.inf), -1e300
    )
    sing_col = llk_ab[:, :, 0, 0]
    sum_single = (
        np.exp(sing_col - max_llk[:, None]).sum(axis=1)
        * (1.0 - doublet_prior) / V
    )
    sum_double = np.einsum(
        "cjkn,jkn->c", np.exp(llk_ab - max_llk[:, None, None, None]), dbl_w
    )
    i1 = np.argmax(sing_col, axis=1)
    masked = sing_col.copy()
    masked[rows, i1] = -np.inf
    i2 = np.argmax(masked, axis=1)
    max2 = np.maximum(masked[rows, i2], -1e300)
    flat_masked = np.where(dbl_msk.reshape(-1)[None, :], flat, -np.inf)
    best = np.argmax(flat_masked, axis=1)
    jb = best // (V * A)
    kb = (best // A) % V
    ab_ = best % A
    return CompactResult(
        sing_col=sing_col,
        llk_00=llk_00,
        max_llk=max_llk,
        sum_single=sum_single,
        sum_double=sum_double,
        i_sing1=i1.astype(np.int64),
        i_sing2=i2.astype(np.int64),
        max_sing2=max2,
        best_flat=best.astype(np.int64),
        pair_llk12=llk_ab[rows, jb, kb, ab_],
        pair_llk10=llk_ab[rows, jb, 0, ab_],
        pair_llk20=llk_ab[rows, kb, 0, ab_],
    )


def decide(llk_ab, llk_00, dbl_w, dbl_msk, doublet_prior):
    """Decision pass on device. llk_ab (B,V,V,A), llk_00 (B,A); dbl_w
    (V,V,A) and dbl_msk (V,V,A) bool built on the host. Returns a dict of
    per-cell tensors."""
    B, V, _, A = llk_ab.shape
    flat = llk_ab.reshape(B, -1)
    # -1e300 seed (:476-501); f32 cannot hold it, so its floor is finfo.min
    seed = -1e300 if flat.dtype == torch.float64 else float(
        torch.finfo(flat.dtype).min)
    max_llk = torch.clamp(flat.max(dim=1).values, min=seed)
    sing_col = llk_ab[:, :, 0, 0]
    sum_single = (
        torch.exp(sing_col - max_llk[:, None]).sum(dim=1)
        * (1.0 - doublet_prior)
        / V
    )
    sum_double = torch.einsum(
        "cjkn,jkn->c", torch.exp(llk_ab - max_llk[:, None, None, None]), dbl_w
    )
    rows = torch.arange(B, device=llk_ab.device)
    i1 = torch.argmax(sing_col, dim=1)
    masked = sing_col.clone()
    masked[rows, i1] = -torch.inf
    i2 = torch.argmax(masked, dim=1)
    max2 = torch.clamp(masked[rows, i2], min=seed)
    flat_masked = torch.where(dbl_msk.reshape(1, -1), flat, -torch.inf)
    best = torch.argmax(flat_masked, dim=1)
    jb = best // (V * A)
    kb = (best // A) % V
    ab_ = best % A
    return dict(
        sing_col=sing_col,
        llk_00=llk_00,
        max_llk=max_llk,
        sum_single=sum_single,
        sum_double=sum_double,
        i_sing1=i1,
        i_sing2=i2,
        max_sing2=max2,
        best_flat=best,
        pair_llk12=llk_ab[rows, jb, kb, ab_],
        pair_llk10=llk_ab[rows, jb, 0, ab_],
        pair_llk20=llk_ab[rows, kb, 0, ab_],
    )


def pack_rows(out, llk, llk0):
    """decide() output + singlet LLKs -> the packed (B, 2V+A+11) f64 rows
    [sing_col(V), llk_00(A), _PACK_KEYS(10), llks(V), llk0s(1)]; integer
    fields ride as exact small f64s."""
    cols = [out["sing_col"], out["llk_00"]]
    for k in _PACK_KEYS:
        cols.append(out[k].to(torch.float64)[:, None])
    cols.append(llk.to(torch.float64))
    cols.append(llk0.to(torch.float64)[:, None])
    return torch.cat(cols, dim=1)


def compact_step_body(parts, tab, n_alpha, n_samples, dbl_w, dbl_msk,
                      doublet_prior, a0_sep=False, sym_a=None,
                      pair_fn=pair_llks, dtype=torch.float64, acct=None):
    """Fused fast block step (``ops/front``: ``front_half`` then
    ``pair_half`` on a decoded block with the engine's ``DeviceTables``
    tab) + decision pass, packed into ONE (B, 2V+A+11) f64 tensor on the
    block's device. dtype: the decision pass's (float32 is the JAX CLI's
    ``--precision f32``, whose casts to f64 stay f32 without x64; dbl_w
    comes in it). The front is the span dispatch.front; everything after
    it (the g gather, the pair search, the singlet contraction, the
    decision and the packing) the span dispatch.pair (``utils/spans``;
    acct: the engine's ``phase_s``, or None for the trace alone)."""
    with span("dispatch.front", acct):
        front = front_half(parts, tab)
    del parts  # the decoded lanes are not held through the pair search
    with span("dispatch.pair", acct):
        llk, llk0, llk_ab, llk_00 = pair_half(
            *front, tab, n_alpha, n_samples, a0_sep=a0_sep, sym_a=sym_a,
            pair_fn=pair_fn,
        )
        del front
        out = decide(llk_ab.to(dtype), llk_00.to(dtype), dbl_w, dbl_msk,
                     doublet_prior)
        return pack_rows(out, llk, llk0)


def compact_step_body_exact(
    parts, tab, n_alpha, n_samples, dbl_w, dbl_msk, doublet_prior,
    a0_sep=False, sym_a=None, front_fn=front_exact, pair_fn=pair_exact,
    acct=None,
):
    """Fused exact block step (f64 throughout) + decision pass, packed
    into ONE (B, 2V+A+11) f64 tensor like ``compact_step_body``. parts: a
    decoded block (``ops/wire.Parts``); tab: the engine's
    ``ExactTables``. front_fn/pair_fn: K2' and K3' (the engine), or their
    plain versions (a check). The front is the span dispatch.front;
    everything after it (the g gather, the pair search, the decision and
    the packing) the span dispatch.pair (``utils/spans``; acct: the
    engine's ``phase_s``, or None for the trace alone)."""
    with span("dispatch.front", acct):
        front = exact_front(parts, tab, front_fn)
    del parts  # the decoded lanes are not held through the pair search
    with span("dispatch.pair", acct):
        llk, llk0, llk_ab, llk_00 = exact_pair(
            *front, tab, n_alpha, n_samples, a0_sep, sym_a, pair_fn)
        del front  # the front's tables are not held through the decision
        out = decide(llk_ab, llk_00, dbl_w, dbl_msk, doublet_prior)
        return pack_rows(out, llk, llk0)
