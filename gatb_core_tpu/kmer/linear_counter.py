"""LinearCounter: probabilistic distinct-kmer cardinality estimator.

Device port of gatb-core's LinearCounter (kmer/impl/LinearCounter.cpp:
43-90): a 1-hash Bloom filter of ``size`` bits; the estimate is the classic
linear-counting formula ``-size * ln((size - weight) / size)`` where
``weight`` is the number of set bits. ``is_accurate`` iff load factor < 0.99
(LinearCounter.cpp:76-81).

Also ports the EstimateNbDistinctKmers wrapper
(kmer/impl/ConfigurationAlgorithm.cpp:64-160): counter sized
``min(nb_kmers_total, max_memory*8*1024*1024/2)`` bits, linear extrapolation
``count * nb_kmers_total / nb_processed`` and worst-case fallback to
``nb_kmers_total`` when inaccurate.

Device mapping: inserts are batched — canonical k-mers from the standard
extraction kernel are hashed (bit-exact hash1 chain, ops/u64.py) and
scattered into a uint32 bit tensor; the weight is one popcount reduction.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from ..collections.bloom import bloom_seeds, _chunk_hash
from ..ops.u64 import u64_mod_u32


class LinearCounter:
    """1-hash Bloom cardinality counter (batched device inserts)."""

    def __init__(self, size_bits: int):
        if size_bits <= 0:
            raise ValueError("size_bits must be positive")
        self.size_bits = int(size_bits)
        self._bits = jnp.zeros((self.size_bits,), jnp.bool_)
        self._seed = 0

    def add(self, limbs, valid=None) -> None:
        """Insert a batch of (N, W) uint32 big-endian kmer limbs."""
        limbs = jnp.asarray(limbs)
        if valid is None:
            valid = jnp.ones((limbs.shape[0],), bool)
        self._bits = _lc_insert(self._bits, limbs, jnp.asarray(valid),
                                self.size_bits, self._seed)

    @property
    def weight(self) -> int:
        return int(jnp.sum(self._bits))

    def count(self) -> int:
        """Linear-counting estimate (LinearCounter.cpp:61-73)."""
        weight = self.weight
        if weight >= self.size_bits:
            weight = self.size_bits - 1  # saturated: avoid log(0)
        return int((-1.0 * self.size_bits)
                   * math.log((1.0 * self.size_bits - weight)
                              / self.size_bits))

    def is_accurate(self) -> bool:
        return (self.weight / self.size_bits) < 0.99


@functools.partial(jax.jit, static_argnames=("size_bits", "seed"))
def _lc_insert(bits, limbs, valid, size_bits: int, seed: int):
    h = _chunk_hash(limbs, bloom_seeds(seed)[0])
    pos = u64_mod_u32(h, size_bits)
    pos = jnp.where(valid, pos, jnp.uint32(size_bits))  # dropped
    return bits.at[pos].set(True, mode="drop")


def estimate_distinct_kmers(bank, kmer_size: int, max_memory_mb: int = 5000,
                            batch_reads: int = 1024,
                            batch_len: int = 256) -> int:
    """EstimateNbDistinctKmers port (ConfigurationAlgorithm.cpp:64-160,
    367-396): stream the bank's canonical kmers through a LinearCounter and
    linearly extrapolate to the configured total kmer estimate."""
    from ..bank.fasta import open_bank
    from ..ops.kmer_ops import extract_kmers
    from .counting import _BatchBuilder

    bank = open_bank(bank)
    est_nb, est_total, est_max = bank.estimate()
    mean_len = est_total // max(est_nb, 1)
    nb_kmers_total = max((mean_len - kmer_size + 1), 0) * max(est_nb, 1)
    if nb_kmers_total == 0:
        return 0
    size_bits = min(nb_kmers_total, max_memory_mb * 8 * 1024 * 1024 // 2)
    counter = LinearCounter(max(size_bits, 64))

    builder = _BatchBuilder(kmer_size, batch_reads, batch_len)
    processed = 0

    def run(codes, valid, lengths, rows):
        nonlocal processed
        kb = extract_kmers(jnp.asarray(codes), jnp.asarray(valid),
                           jnp.asarray(lengths), kmer_size)
        flat = kb.kmers.reshape(-1, kb.kmers.shape[-1])
        v = kb.valid.reshape(-1)
        counter.add(flat, v)
        processed += int(jnp.sum(kb.valid))

    for seq in bank:
        for batch in builder.add(seq.data):
            run(*batch)
    if builder.row:
        run(*builder.flush())

    if processed == 0:
        return 0
    if not counter.is_accurate():
        return int(nb_kmers_total)  # worst-case fallback (:157-161)
    return int(counter.count() * (nb_kmers_total / processed))
