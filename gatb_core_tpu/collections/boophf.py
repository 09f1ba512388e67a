"""BooPHF-style minimal perfect hash (BBHash algorithm), on the device.

Reference: gatb-core's BooPHF wrapper (tools/collections/impl/BooPHF.hpp:230-340)
over the vendored BBHash (thirdparty/BooPHF/BooPHF.h): a cascade of level
bitvectors — at each level every remaining key is hashed into a gamma*n-slot
bit array; slots hit exactly once become final (bit set), colliding keys fall
through to the next level; leftovers after the last level go to a small exact
fallback. The code of a key is the rank of its set bit across all levels
(gamma = 3.0 for fast build, BooPHF.hpp:269).

Device design: the query is branch-free and constant-time — per level one
64-bit hash (ops/u64.py pair arithmetic), one bitvector word gather, one
prefix-rank gather and a `lax.population_count`; levels are unrolled (static
count). Ranks use per-word prefix popcounts so no select/scan runs at query
time. The build hashes on device (same bit-exact hash as the query path) and
does the once-hit analysis with host bincounts — an O(n) one-off.

Unlike the reference we keep MPHF codes aligned with the sorted-table rank
used everywhere else (collections/sortedset.py): ``perm[code] -> sorted
rank``, so this structure is a drop-in constant-time accelerator for
`SortedKmerSet.rank` with identical return values.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.u64 import U64, hash64, u64_xor, u64_mod_u32

I32 = jnp.int32
U32 = jnp.uint32

# fixed per-level seeds (our own constants; the level hash only needs to be
# deterministic and well-mixed — reference BBHash likewise re-seeds per level)
LEVEL_SEEDS = (
    0x9E3779B97F4A7C15,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
    0x85EBCA6B2F165667,
)
DEFAULT_LEVELS = 4
GAMMA = 3.0  # BooPHF.hpp:269 (gamma=3 chosen by gatb for fast build)


def _limbs_to_u64(limbs: jnp.ndarray) -> list[U64]:
    """(N, W) big-endian uint32 limbs -> list of 64-bit chunks (hi, lo).

    Mirrors the reference's per-64-bit-chunk hashing of LargeInt
    (tools/math/LargeInt.hpp:738-749: XOR of hash64 over uint64 words).
    """
    n, w = limbs.shape
    if w % 2:
        pad = jnp.zeros((n, 1), U32)
        limbs = jnp.concatenate([pad, limbs], axis=1)
        w += 1
    return [U64(limbs[:, j], limbs[:, j + 1]) for j in range(0, w, 2)]


def _level_hash(limbs: jnp.ndarray, seed: int, size: int) -> jnp.ndarray:
    """Per-level slot index: XOR of chunk hashes mod the level size."""
    chunks = _limbs_to_u64(limbs)
    h = None
    seed64 = U64.from_int(seed, like=chunks[0].lo)
    for c in chunks:
        hc = hash64(c, seed64)
        h = hc if h is None else u64_xor(h, hc)
    return u64_mod_u32(h, size)


@functools.partial(jax.jit, static_argnames=("seed", "size"))
def _level_hash_jit(limbs, seed: int, size: int):
    return _level_hash(limbs, seed, size)


def _round_up_64(x: int) -> int:
    return max(64, (x + 63) & ~63)


class BooPHF:
    """Static minimal perfect hash over a sorted distinct kmer table.

    Query returns the *sorted rank* (same codes as SortedKmerSet.rank) in
    O(levels) gathers instead of O(log n) binary-search rounds.
    """

    def __init__(self, sizes, bits, prefix, offsets, fallback_keys,
                 fallback_ranks, perm, n):
        self.sizes = sizes                  # per-level slot counts
        self.bits = bits                    # (total_words,) uint32 bitvector
        self.prefix = prefix                # (total_words,) int32 rank prefix
        self.offsets = offsets              # per-level word offsets
        self.fallback_keys = fallback_keys  # (F, W) sorted leftover keys
        self.fallback_ranks = fallback_ranks  # (F,) their sorted ranks
        self.perm = perm                    # (n,) code -> sorted rank
        self.n = n

    # ------------------------------------------------------------------ build

    @classmethod
    def build(cls, limbs, n: int, levels: int = DEFAULT_LEVELS,
              gamma: float = GAMMA) -> "BooPHF":
        """limbs: (C, W) sorted distinct keys (rows >= n are padding)."""
        limbs = jnp.asarray(limbs)
        keys = np.asarray(limbs[:n])
        remaining = np.arange(n)            # sorted ranks still unplaced
        sizes: list[int] = []
        level_bits: list[np.ndarray] = []
        codes = np.full(n, -1, np.int64)
        next_code = 0
        for lvl in range(levels):
            if len(remaining) == 0:
                sizes.append(64)
                level_bits.append(np.zeros(2, np.uint32))
                continue
            size = _round_up_64(int(gamma * len(remaining)))
            h = np.asarray(_level_hash_jit(
                jnp.asarray(keys[remaining]), LEVEL_SEEDS[lvl], size))
            counts = np.bincount(h, minlength=size)
            placed = counts[h] == 1
            # bit set exactly at once-hit slots
            bv = np.zeros(size // 32, np.uint32)
            slots = h[placed]
            np.bitwise_or.at(bv, slots >> 5,
                             np.uint32(1) << (slots & 31).astype(np.uint32))
            sizes.append(size)
            level_bits.append(bv)
            # codes: rank of slot among set bits of this level, offset by
            # previously assigned codes
            order = np.argsort(slots, kind="stable")
            codes[remaining[placed][order]] = next_code + np.arange(len(slots))
            next_code += len(slots)
            remaining = remaining[~placed]

        # fallback: leftover keys, exact sorted-array lookup
        fallback_ranks = remaining.astype(np.int64)
        fallback_keys = keys[remaining]
        codes[remaining] = next_code + np.arange(len(remaining))

        # flatten bitvectors + per-word rank prefix (exclusive)
        offsets = []
        word_off = 0
        for bv in level_bits:
            offsets.append(word_off)
            word_off += len(bv)
        bits = (np.concatenate(level_bits) if level_bits
                else np.zeros(1, np.uint32))
        pop = np.array([bin(w).count("1") for w in bits.tolist()], np.int64)
        prefix = np.concatenate([[0], np.cumsum(pop)[:-1]]).astype(np.int32)

        perm = np.full(max(n, 1), -1, np.int32)
        if n:
            assert (codes >= 0).all()
            perm[codes] = np.arange(n, dtype=np.int32)
        return cls(tuple(sizes), jnp.asarray(bits), jnp.asarray(prefix),
                   tuple(offsets), jnp.asarray(fallback_keys),
                   jnp.asarray(fallback_ranks.astype(np.int32)),
                   jnp.asarray(perm), n)

    # ------------------------------------------------------------------ query

    def rank(self, queries: jnp.ndarray) -> jnp.ndarray:
        """(Q, W) -> (Q,) sorted rank; valid only for keys in the set
        (MPHF contract, like reference BooPHF). Constant-time gathers."""
        if self.n == 0:
            return jnp.full((queries.shape[0],), -1, I32)
        return _boophf_rank(queries, self.bits, self.prefix, self.perm,
                            self.fallback_keys, self.fallback_ranks,
                            self.sizes, self.offsets)


@functools.partial(jax.jit, static_argnames=("sizes", "offsets"))
def _boophf_rank(queries, bits, prefix, perm, fb_keys, fb_ranks,
                 sizes: tuple, offsets: tuple):
    q = queries.shape[0]
    code = jnp.full((q,), -1, I32)
    level_base = 0
    for lvl, (size, woff) in enumerate(zip(sizes, offsets)):
        idx = _level_hash(queries, LEVEL_SEEDS[lvl], size)
        word_i = woff + (idx >> 5).astype(I32)
        word = bits[word_i]
        bitpos = (idx & 31).astype(U32)
        hit = ((word >> bitpos) & 1) != 0
        below = word & ((U32(1) << bitpos) - 1)
        rank = (prefix[word_i] - prefix[woff]
                + jax.lax.population_count(below).astype(I32))
        code = jnp.where((code < 0) & hit, level_base + rank, code)
        # number of set bits in this level = prefix[next word] boundary;
        # computed statically-shaped: popcount prefix difference
        nwords = size // 32
        end = woff + nwords
        total_lvl = (prefix[end] if end < prefix.shape[0]
                     else prefix[-1] + jax.lax.population_count(
                         bits[-1]).astype(I32))
        level_base = level_base + (total_lvl - prefix[woff])
    # fallback: binary search the leftover sorted keys
    if fb_keys.shape[0]:
        from .sortedset import _searchsorted_limbs

        pos = _searchsorted_limbs(fb_keys, queries, fb_keys.shape[0])
        safe = jnp.minimum(pos, fb_keys.shape[0] - 1)
        found = jnp.all(fb_keys[safe] == queries, axis=-1) \
            & (pos < fb_keys.shape[0])
        code = jnp.where((code < 0) & found, level_base + safe, code)
    out = jnp.where(code >= 0, perm[jnp.maximum(code, 0)], -1)
    return out.astype(I32)
