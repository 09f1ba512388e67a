"""Debloom: critical false positive (cFP) set construction.

Port of gatb-core DebloomAlgorithm (kmer/impl/DebloomAlgorithm.cpp) /
DebloomMinimizerAlgorithm: the de Bruijn graph membership oracle is
(Bloom AND not cFP), where cFP = the Bloom's false positives among the
1-neighborhood of solid kmers — exactly the queries graph traversal can
make. Phases (DebloomAlgorithm.cpp:270-600):

  1. probe all 8 neighbor extensions of every solid kmer against the Bloom
  2. subtract the true-solid kmers
  3. persist the remainder as a sorted set (DebloomKind 'original'
     ContainerSet; the reference's 'cascading' variant is an alternative
     *encoding* of the same set)

On the device phases 1-2 are one batched kernel sweep: candidate generation +
Bloom gather + sorted-set rank, then a host-side unique.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..collections.bloom import BloomFilter, build_bloom, \
    debloom_nbits_per_kmer, optimal_params
from ..collections.sortedset import SortedKmerSet
from ..ops.neighbor_ops import neighbor_candidates


@dataclass
class CascadeCFP:
    """Cascading-bloom encoding of the cFP set (DebloomAlgorithm::createCFP
    DEBLOOM_CASCADING branch, kmer/impl/DebloomAlgorithm.cpp:487-590):
    bloom2 over cFP, bloom3 over T2 = {solid hit by bloom2}, bloom4 over
    T3 = {cFP hit by bloom3}, and the exact sorted set T4 = {T2 hit by
    bloom4}. All three blooms use the cache-coherent kind (forced,
    :497)."""

    blooms: list            # [bloom2, bloom3, bloom4]
    t4: np.ndarray          # (T, W) sorted exact leftover set


@dataclass
class DebloomResult:
    bloom: BloomFilter
    cfp: np.ndarray           # (C, W) sorted critical false positives
    nb_cfp: int
    info: dict
    kind: str = "original"
    cascade: CascadeCFP | None = None


def _f32(x) -> float:
    return float(np.float32(x))


def build_cascading_cfp(solid_limbs: np.ndarray, cfp_limbs: np.ndarray,
                        k: int, user_seed: int = 0) -> CascadeCFP:
    """Exact port of the cascading cFP construction
    (DebloomAlgorithm.cpp:487-590, float32 size arithmetic preserved)."""
    nbits = debloom_nbits_per_kmer(k, True)
    nb_solid = len(solid_limbs)
    nb_cfp = len(cfp_limbs)
    n_hash = max(1, int(np.floor(np.float32(0.7 * _f32(nbits)))))
    # powf computes in float32: (double)powf((double)0.62,(double)nbits)
    pw = float(np.power(np.float32(0.62), np.float32(nbits),
                        dtype=np.float32))
    t2_est = max(int(np.ceil(np.float32(nb_solid * pw))), 1)
    t3_est = max(int(np.ceil(np.float32(nb_cfp * pw))), 1)

    def sized_bloom(items: np.ndarray, est_items: int) -> BloomFilter:
        from ..collections.bloom import _bloom_build

        size = int(np.float32(est_items) * np.float32(nbits))
        size = max(size, 1)
        words = _bloom_build(jnp.asarray(items if len(items) else
                                         np.zeros((1, solid_limbs.shape[1]),
                                                  np.uint32)),
                             jnp.asarray(np.ones(max(len(items), 1), bool)
                                         if len(items) else
                                         np.zeros(1, bool)),
                             size, n_hash, user_seed, "cache", k)
        return BloomFilter(words, size, n_hash, user_seed, "cache", k)

    bloom2 = sized_bloom(cfp_limbs, nb_cfp)
    t2 = solid_limbs[np.asarray(bloom2.contains(jnp.asarray(solid_limbs)))] \
        if nb_solid else solid_limbs
    bloom3 = sized_bloom(t2, t2_est)
    t3 = cfp_limbs[np.asarray(bloom3.contains(jnp.asarray(cfp_limbs)))] \
        if nb_cfp else cfp_limbs
    bloom4 = sized_bloom(t3, t3_est)
    t4 = t2[np.asarray(bloom4.contains(jnp.asarray(t2)))] if len(t2) else t2
    # reference sorts cfpItems (already ascending here: t2 preserves the
    # sorted solid order and t4 filters it)
    return CascadeCFP([bloom2, bloom3, bloom4], t4)


def build_debloom(solid_limbs: np.ndarray, k: int,
                  bloom_nbits: float | None = None,
                  cascading: bool = False, user_seed: int = 0,
                  bloom_kind: str = "neighbor",
                  chunk: int | None = None, mesh=None) -> DebloomResult:
    """Build Bloom + cFP over the solid set (BloomAlgorithm +
    DebloomAlgorithm equivalents). ``bloom_kind`` defaults to the
    reference graph build's main-bloom default (neighbor-coherent — a
    reference dbgh5 .h5 carries /bloom kind='neighbor');
    ``cascading`` selects the cFP encoding (reference default kind).
    With ``mesh``, the 8-probe extension sweep runs range-sharded over
    the device mesh (parallel/postsolid.distributed_debloom_probe) —
    the resulting cFP set is identical."""
    n = len(solid_limbs)
    w = solid_limbs.shape[1] if n else 1
    if bloom_nbits is None:
        # NBITS_PER_KMER formula (DebloomAlgorithm.cpp:628-650)
        bloom_nbits = debloom_nbits_per_kmer(k, cascading)
    from ..ops.sortops import pad_rows_pow2, sweep_chunk

    # ONE pow2-padded upload serves both the bloom build (padding rows
    # masked invalid) and the probe sweep's sort-join — the table is the
    # bulk of this stage's host->device traffic
    ptab, _ = pad_rows_pow2(solid_limbs if n else
                            np.zeros((1, w), np.uint32))
    jtab = jnp.asarray(ptab)
    pvalid = np.zeros(len(ptab), bool)
    pvalid[:n] = True
    bloom = build_bloom(jtab, jnp.asarray(pvalid),
                        nbits_per_kmer=bloom_nbits,
                        nb_items=max(n, 1), user_seed=user_seed,
                        kind=bloom_kind, kmer_size=k)

    if mesh is not None and n:
        from ..parallel.postsolid import distributed_debloom_probe

        cfp = distributed_debloom_probe(mesh, solid_limbs, k, bloom)
    else:
        cfp_parts = []
        # few, large chunks: each chunk's sort-join re-sorts the whole
        # table AND pays a dispatch; pow2 table + traced n keep one compile per
        # capacity bucket (r4 shape discipline)
        csize = min(sweep_chunk(max(n, 1)), len(ptab))
        if chunk:                   # caller-imposed bound
            csize = min(csize, chunk)
        from ..ops.sortops import _next_pow2 as _np2

        # expected cFP rate is a few % of the 8 probes/node; overflow
        # doubles the capacity and retries (exact either way)
        cap_out = _np2(max(4096, (csize * 8) // 32))
        for i in range(0, n, csize):
            part = solid_limbs[i:i + csize]
            npart = len(part)
            if npart < csize:
                # pad rows REPEAT row 0 (not all-zero fake kmers): their
                # candidate hits are either dups of row 0's (deduped on
                # device) or bloom misses
                part = np.concatenate(
                    [part, np.broadcast_to(part[:1],
                                           (csize - npart, w))])
            while True:
                out_p, n_hit, ovf = _debloom_probe_compact(
                    jnp.asarray(part), jtab, jnp.int32(n), bloom.words,
                    k=k, size_bits=bloom.size_bits,
                    n_hash=bloom.n_hash, seed=user_seed,
                    kind=bloom.kind, cap_out=cap_out)
                if not bool(np.asarray(ovf)):
                    break
                cap_out *= 2
            nh = int(np.asarray(n_hit))
            if nh:
                cfp_parts.append(np.stack(
                    [np.asarray(p[:nh]) for p in out_p], axis=1))

        if cfp_parts:
            allc = np.concatenate(cfp_parts, axis=0)
            cfp = np.unique(allc, axis=0) if len(cfp_parts) > 1 \
                else allc
        else:
            cfp = np.zeros((0, w), np.uint32)

    # reference falls back to ORIGINAL when there are no false positives
    # (DebloomAlgorithm.cpp:476-478)
    kind = "cascading" if (cascading and len(cfp)) else "original"
    cascade = None
    if kind == "cascading":
        cascade = build_cascading_cfp(solid_limbs, cfp, k, user_seed)

    info = {
        "bloom_size_bits": bloom.size_bits,
        "bloom_nb_hash": bloom.n_hash,
        "nbits_per_kmer": bloom_nbits,
        "nb_cfp": int(len(cfp)),
        "debloom_kind": kind,
    }
    return DebloomResult(bloom, cfp, len(cfp), info, kind, cascade)


@functools.partial(jax.jit, static_argnames=("k", "size_bits", "n_hash",
                                             "seed", "kind"))
def _debloom_probe(nodes, table, n_table, bloom_words, *, k: int,
                   size_bits: int, n_hash: int, seed: int,
                   kind: str = "basic"):
    """8-extension cFP probe sweep with a TRACED table size (one compile
    per pow2 capacity bucket): Bloom gather + sort-join membership — the
    reference's 8 probes/solid kmer hot loop (DebloomAlgorithm.cpp:
    270-300) without random gathers."""
    from ..collections.bloom import _bloom_contains
    from ..ops.sortops import rank_join_traced

    cands = neighbor_candidates(nodes, k)            # (C, 8, W)
    c, _, w = cands.shape
    flat = cands.reshape(c * 8, w)
    in_bloom = _bloom_contains(bloom_words, flat, size_bits, n_hash,
                               seed, kind, k)
    _, solid = rank_join_traced(table, flat, n_table)
    return in_bloom & ~solid, cands


@functools.partial(jax.jit, static_argnames=("k", "size_bits", "n_hash",
                                             "seed", "kind", "cap_out"))
def _debloom_probe_compact(nodes, table, n_table, bloom_words, *, k: int,
                           size_bits: int, n_hash: int, seed: int,
                           kind: str, cap_out: int):
    """_debloom_probe + on-device dedup/compaction of the cFP hits (r5):
    the r4 path fetched ALL (C, 8, W) candidates (~72 MB at 1M nodes)
    and np.unique'd them on host; here the
    hit rows sort/dedup on device and only the (cap_out, W) distinct
    cFP table is fetched. Returns (planes, n, overflow)."""
    from ..collections.bloom import _bloom_contains
    from ..ops.sortops import count_planes, rank_join_traced

    cands = neighbor_candidates(nodes, k)
    c, _, w = cands.shape
    flat = cands.reshape(c * 8, w)
    in_bloom = _bloom_contains(bloom_words, flat, size_bits, n_hash,
                               seed, kind, k)
    _, solid = rank_join_traced(table, flat, n_table)
    hit = in_bloom & ~solid
    planes = tuple(flat[:, j] for j in range(w))
    out_p, _, n, ovf = count_planes(planes, hit, spare_bits=True,
                                    cap_out=cap_out)
    return out_p, n, ovf


class BloomCfpContainer:
    """Graph membership oracle: bloom(x) and not cfp(x)
    (ContainerNode equivalent, debruijn/impl/ContainerNode.hpp:60-90).

    Exact for every query in the 1-neighborhood of solid kmers — the
    closure traversal operates in. When the debloom kind is cascading,
    the cFP test is the bloom chain (ContainerNodeCascading::containsCFP,
    ContainerNode.hpp:174-186): in-cFP iff bloom2(x) and (not bloom3(x)
    or (bloom4(x) and x not in T4))."""

    def __init__(self, debloom: DebloomResult):
        self.bloom = debloom.bloom
        self.kind = debloom.kind
        if debloom.kind == "cascading" and debloom.cascade is not None:
            self.cascade = debloom.cascade
            self.t4 = SortedKmerSet(jnp.asarray(self.cascade.t4),
                                    len(self.cascade.t4))
            self.cfp = None
        else:
            self.cascade = None
            self.cfp = SortedKmerSet(jnp.asarray(debloom.cfp),
                                     len(debloom.cfp))

    def _contains_cfp(self, q) -> jnp.ndarray:
        if self.cascade is None:
            return self.cfp.contains(q)
        b2, b3, b4 = self.cascade.blooms
        in2 = b2.contains(q)
        in3 = b3.contains(q)
        in4 = b4.contains(q)
        in_t4 = self.t4.contains(q)
        return in2 & (~in3 | (in4 & ~in_t4))

    def contains(self, queries) -> np.ndarray:
        q = jnp.asarray(np.atleast_2d(queries))
        hit = self.bloom.contains(q)
        return np.asarray(hit & ~self._contains_cfp(q))
