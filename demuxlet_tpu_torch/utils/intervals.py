"""Genome interval sets (host-side): the genomeLoci analog.

Reference: genomeLoci.h:13-286 — an ordered set of chrom:beg1-end0 intervals
with merge/resolveOverlaps (:174-206) and binary-search contains/overlaps/
moveTo (:218-285). Used for target-region filtering and for planning
genome-sharded ingest (the genomeChunk work partitioner's substrate).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple


@dataclass(frozen=True, order=True)
class Locus:
    chrom: str
    beg1: int  # 1-based inclusive
    end0: int  # 1-based inclusive end (reference's end0 convention)

    def overlaps(self, other: "Locus") -> bool:
        return (
            self.chrom == other.chrom
            and self.beg1 <= other.end0
            and other.beg1 <= self.end0
        )

    def contains1(self, chrom: str, pos1: int) -> bool:
        return self.chrom == chrom and self.beg1 <= pos1 <= self.end0


def parse_region(s: str) -> Locus:
    """'chr1', 'chr1:100', or 'chr1:100-200' (1-based inclusive)."""
    if ":" not in s:
        return Locus(s, 1, 1 << 60)
    chrom, rng = s.split(":", 1)
    if "-" in rng:
        b, e = rng.split("-", 1)
        return Locus(chrom, int(b), int(e))
    return Locus(chrom, int(rng), int(rng))


class GenomeLoci:
    """Ordered interval set with reference-equivalent merge semantics."""

    def __init__(self) -> None:
        self._by_chrom: Dict[str, List[Tuple[int, int]]] = {}
        self._dirty = False

    def add(self, chrom: str, beg1: int, end0: int) -> None:
        self._by_chrom.setdefault(chrom, []).append((beg1, end0))
        self._dirty = True

    def add_region(self, s: str) -> None:
        l = parse_region(s)
        self.add(l.chrom, l.beg1, l.end0)

    def resolve_overlaps(self) -> None:
        """Merge overlapping/adjacent intervals (genomeLoci.h:174-206)."""
        for chrom, ivs in self._by_chrom.items():
            ivs.sort()
            out: List[Tuple[int, int]] = []
            for b, e in ivs:
                if out and b <= out[-1][1] + 1:
                    out[-1] = (out[-1][0], max(out[-1][1], e))
                else:
                    out.append((b, e))
            self._by_chrom[chrom] = out
        self._dirty = False

    def _ready(self) -> None:
        if self._dirty:
            self.resolve_overlaps()

    def __len__(self) -> int:
        self._ready()
        return sum(len(v) for v in self._by_chrom.values())

    def empty(self) -> bool:
        return len(self) == 0

    def __iter__(self) -> Iterator[Locus]:
        self._ready()
        for chrom in sorted(self._by_chrom):
            for b, e in self._by_chrom[chrom]:
                yield Locus(chrom, b, e)

    def total_length(self) -> int:
        self._ready()
        return sum(
            e - b + 1 for ivs in self._by_chrom.values() for b, e in ivs
        )

    def contains1(self, chrom: str, pos1: int) -> bool:
        """Binary-search point membership (genomeLoci moveTo/contains)."""
        self._ready()
        ivs = self._by_chrom.get(chrom)
        if not ivs:
            return False
        i = bisect.bisect_right(ivs, (pos1, 1 << 62)) - 1
        return i >= 0 and ivs[i][0] <= pos1 <= ivs[i][1]

    def overlaps(self, chrom: str, beg1: int, end0: int) -> bool:
        self._ready()
        ivs = self._by_chrom.get(chrom)
        if not ivs:
            return False
        i = bisect.bisect_left(ivs, (beg1, 0))
        if i > 0 and ivs[i - 1][1] >= beg1:
            return True
        return i < len(ivs) and ivs[i][0] <= end0

    def chunks(self, unit: int) -> "GenomeLoci":
        """Split every interval into <= unit-bp chunks (genomeChunk.cpp:
        91-126's chunking of chromosomes into unit-bp work items)."""
        out = GenomeLoci()
        self._ready()
        for l in self:
            b = l.beg1
            while b <= l.end0:
                e = min(b + unit - 1, l.end0)
                out.add(l.chrom, b, e)
                b = e + 1
        out._dirty = False
        return out


def read_fai(path: str) -> List[Tuple[str, int]]:
    """FASTA .fai parse: [(chrom, length)] — the chunk planner's chromosome
    source (reference_sequence.h usage in genomeChunk.cpp:97-105)."""
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.split("\t")
            if len(f) >= 2:
                out.append((f[0], int(f[1])))
    return out


def plan_genome_chunks(
    fai: List[Tuple[str, int]], unit: int,
    target: Optional[GenomeLoci] = None,
) -> GenomeLoci:
    """Whole-genome work partition in unit-bp intervals (genomeChunk)."""
    g = GenomeLoci()
    for chrom, ln in fai:
        g.add(chrom, 1, ln)
    g.resolve_overlaps()
    chunks = g.chunks(unit)
    if target is not None and not target.empty():
        out = GenomeLoci()
        for l in chunks:
            if target.overlaps(l.chrom, l.beg1, l.end0):
                out.add(l.chrom, l.beg1, l.end0)
        for ivs in out._by_chrom.values():
            ivs.sort()
        out._dirty = False  # keep chunk boundaries (don't re-merge adjacent)
        return out
    return chunks


def split_genome_shards(
    chrom_lengths: List[Tuple[str, int]], n_shards: int,
) -> List[List[Tuple[str, int, int]]]:
    """Partition the genome into n_shards contiguous, bp-balanced region
    groups: [(chrom, beg1, end0), ...] per shard, in genome order.

    The TPU-native genome-axis ingest decomposition (reference analog:
    genomeChunk unit-bp work items, genomeChunk.cpp:91-126): each shard
    scans only its regions' file ranges via the BAI, SNPs partition
    exactly by position, and per-shard LLK contributions sum."""
    total = sum(ln for _, ln in chrom_lengths)
    n_shards = max(1, n_shards)
    unit = max(1, -(-total // n_shards))
    chunks: List[Tuple[str, int, int]] = []
    for chrom, ln in chrom_lengths:
        b = 1
        while b <= ln:
            e = min(b + unit - 1, ln)
            chunks.append((chrom, b, e))
            b = e + 1
    # group consecutive chunks, balancing total bp
    shards: List[List[Tuple[str, int, int]]] = [[] for _ in range(n_shards)]
    acc = 0
    for chrom, b, e in chunks:
        idx = min(acc // unit, n_shards - 1)
        shards[idx].append((chrom, b, e))
        acc += e - b + 1
    return shards
