"""Multi-device execution: the device mesh and the slot-axis step (port of
``demuxlet_tpu/parallel/mesh.py``).

A mesh is an (n_b, n_s) grid of ``torch.device``s with the JAX mesh's two
axes:

  axis "b" (barcodes) -- data parallelism: the engine gives whole cell
                         blocks to the mesh rows in turn (block i to row
                         i mod n_b); each row runs the single-device step
                         on its first member. Every output is per cell, so
                         this is exact.
  axis "s" (SNP slots) -- the dense route's reduction axis: each member of
                         a row takes a contiguous part of every cell's
                         slots and computes partial log-likelihood sums,
                         which the row's first member adds in member order
                         (a fixed order, no atomics).

It is a plain grid, not ``torch.distributed.DeviceMesh``, which needs one
process per device: here one process drives every member, as a JAX
process drives its local devices. Members may repeat a device (several
members on one card, or all of them the CPU for tests).

Where the JAX step factories went:

* ``build_sharded_step`` (the XLA f64 step sharded over "b" and "s") is
  ``build_sharded_step`` below, for the "s" axis; the engine carries "b".
* ``build_sharded_fast_step``, ``build_sharded_compact_step``,
  ``build_sharded_exact_compact_step`` and
  ``build_sharded_exact_pallas_step`` (the kernel steps sharded over "b")
  need no step factory: the engine runs its single-device kernel step on each
  row's member (``models/engine.py``). The JAX mesh path drops to the v1
  wire (its ``engine.py:259``); the port keeps wire v2 and the kernels
  unchanged on every member.
* ``shard_block`` and ``replicate`` (device_put with shardings) become
  the engine's H2D of each slot part to its member and the member's own
  tables.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from demuxlet_tpu_torch.ops import likelihood


@dataclass(frozen=True)
class Mesh:
    """An (n_b, n_s) grid of devices: ``devices[b][s]``."""

    devices: tuple  # n_b rows of n_s torch.device

    @property
    def shape(self) -> dict:
        """{"b": n_b, "s": n_s}, as a JAX mesh's ``shape``."""
        return {"b": len(self.devices), "s": len(self.devices[0])}


def make_mesh(n_b: Optional[int], n_s: int, devices: Sequence) -> Mesh:
    """Build a ("b", "s") mesh over the given devices, row-major.

    n_b None means len(devices) // n_s (all devices used)."""
    devices = [torch.device(d) for d in devices]
    if n_s < 1:
        raise ValueError("n_s must be >= 1")
    if n_b is None:
        n_b = len(devices) // n_s
    need = n_b * n_s
    if need > len(devices):
        raise ValueError(
            f"mesh {n_b}x{n_s} needs {need} devices, have {len(devices)}")
    if need < 1:
        raise ValueError(f"mesh {n_b}x{n_s} has no device")
    return Mesh(tuple(tuple(devices[b * n_s:(b + 1) * n_s])
                      for b in range(n_b)))


def pad_to_mesh(n: int, shard: int, block: int = 1) -> int:
    """Round n up so it divides evenly into `shard` shards of multiple-of-
    `block` size."""
    per = math.ceil(n / shard)
    per = ((per + block - 1) // block) * block
    return per * shard


def split_slots(n_s: int, *arrays):
    """The slot axis (axis 1) of each (B, S, ...) array in n_s contiguous
    parts of S // n_s slots: a list of n_s tuples, part k for member k of
    a row. S must divide by n_s (the engine pads slots to a power of two
    of at least n_s)."""
    S = arrays[0].shape[1]
    if S % n_s:
        raise ValueError(f"{S} slots do not split over {n_s} members")
    per = S // n_s
    return [tuple(a[:, k * per:(k + 1) * per] for a in arrays)
            for k in range(n_s)]


def build_sharded_step(
    mesh: Mesh,
    n_alpha: int,
    slot_chunk: int = 0,
    dtype=torch.float64,
):
    """The dense route's demux step over one mesh row, split on the slot
    axis (the JAX ``build_sharded_step``'s "s" axis and its ``psum``).

    Signature: step(row, parts, tables) -> (llk[B,V], llk0[B],
    llkAB[B,V,V,A], llk00[B,A]) on the row's first member. parts[k] is
    member k's (idx, msk, cnt) slot part (``split_slots``) and tables[k]
    its (gps, gp0, logf, w), both on member k; each member runs
    ``ops/likelihood.block_llks`` on its part, and the first member adds
    the partial sums in member order."""

    def step(row, parts, tables):
        members = mesh.devices[row]
        if len(parts) != len(members) or len(tables) != len(members):
            raise ValueError(f"mesh row {row} has {len(members)} members, "
                             f"got {len(parts)} parts and {len(tables)} "
                             "table sets")
        outs = [likelihood.block_llks(*p, *t, n_alpha, slot_chunk=slot_chunk,
                                      dtype=dtype)
                for p, t in zip(parts, tables)]
        lead = members[0]
        total = outs[0]
        for out in outs[1:]:
            total = tuple(a + b.to(lead) for a, b in zip(total, out))
        return total

    return step
