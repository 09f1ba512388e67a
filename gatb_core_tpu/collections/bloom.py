"""Bloom filters as device bit tensors with batched probe kernels.

Device equivalent of gatb-core's IBloom family (tools/collections/impl/
Bloom.hpp:113-1290). The reference's synchronized/cache-coherent variants
exist to manage CPU atomics and cache lines; on the device the build is a scatter
of idempotent True writes and the query is a vectorized gather — so one
implementation covers Bloom/BloomSynchronized/BloomCacheCoherent use cases.

Hash family: bit-exact port of the reference's seeded hash1 chain
(Bloom.hpp:81-92 seed generation, NativeInt64.hpp:175-188 hash64,
LargeInt.hpp:738-749 per-64-bit-chunk XOR) so filter sizes/false-positive
behavior match the reference's for the same parameters.

Sizing formulas (BloomAlgorithm.cpp:161-163):
  size = nb_items * nbits_per_kmer, n_hash = max(1, floor(0.7 * nbits))
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.u64 import U64, hash64, u64_mod_u32, u64_xor

NSEEDSBLOOM = 10
_RBASE = [
    0xAAAAAAAA55555555, 0x33333333CCCCCCCC, 0x6666666699999999,
    0xB5B5B5B54B4B4B4B, 0xAA55AA5555335533, 0x33CC33CCCC66CC66,
    0x6699669999B599B5, 0xB54BB54B4BAA4BAA, 0xAA33AA3355CC55CC,
    0x33663366CC99CC99,
]


def bloom_seeds(user_seed: int = 0) -> list[int]:
    """Seed table generation, bit-exact (Bloom.hpp:81-92)."""
    seeds = list(_RBASE)
    for i in range(NSEEDSBLOOM):
        seeds[i] = (seeds[i] * seeds[(i + 3) % NSEEDSBLOOM] + user_seed) \
            & 0xFFFFFFFFFFFFFFFF
    return seeds


def optimal_params(nb_items: int, nbits_per_kmer: float) -> tuple[int, int]:
    """(size_bits, n_hash) exactly as BloomAlgorithm::execute computes them
    (BloomAlgorithm.cpp:159-165) — the C expression
    ``(u_int64_t)(solidKmersNb * NBITS_PER_KMER)`` multiplies in float32
    (NBITS is a C float), and ``(int)floorf(0.7*NBITS)`` rounds through
    float32 too; both are reproduced bit-for-bit so bloom sizes (and hence
    false-positive/cFP sets) match the reference binary."""
    f = np.float32
    size = int(f(nb_items) * f(nbits_per_kmer))
    if size == 0:
        size = 1000  # BloomAlgorithm.cpp:165
    n_hash = int(np.floor(f(0.7 * float(f(nbits_per_kmer)))))
    return size, max(1, min(n_hash, NSEEDSBLOOM))


def _chunk_hash(limbs: jnp.ndarray, seed: int) -> U64:
    """XOR of hash64 over the 64-bit chunks of each kmer
    (LargeInt.hpp:738-749). limbs: (N, W32) big-endian uint32."""
    n, w32 = limbs.shape
    seed_u = U64.from_int(seed, like=limbs[:, 0])
    acc = None
    # little-endian 64-bit words from big-endian u32 limbs
    padded = limbs if w32 % 2 == 0 else jnp.concatenate(
        [jnp.zeros((n, 1), jnp.uint32), limbs], axis=1)
    nw = padded.shape[1] // 2
    for j in range(nw):
        hi = padded[:, 2 * j]
        lo = padded[:, 2 * j + 1]
        h = hash64(U64(hi, lo), seed_u)
        acc = h if acc is None else u64_xor(acc, h)
    return acc


class BloomFilter(NamedTuple):
    """Packed bloom bit array (device) + parameters.

    kind 'basic'  — every probe = hash1(seed_i) mod size
                    (reference Bloom/BloomSynchronized, Bloom.hpp:113-416)
    kind 'cache'  — h0 = hash1(seed_0) mod size; probes i>=1 land in the
                    2^12-bit block at h0: h0 + (simplehash16(key, i) & fff)
                    (reference BloomCacheCoherent, Bloom.hpp:430-497 — the
                    default BloomKind of a graph build, Enums.hpp:73).
                    The bit array carries 2*2^12 slack bits past size_bits,
                    exactly like the reference ctor (Bloom.hpp:438-442).
    """

    words: jnp.ndarray      # (ceil((size+pad)/32),) uint32 packed bits
    size_bits: int          # logical size (== _reduced_tai for 'cache')
    n_hash: int
    user_seed: int
    kind: str = "basic"
    kmer_size: int = 0      # needed by the 'neighbor' kind only

    def contains(self, limbs: jnp.ndarray) -> jnp.ndarray:
        """Batched membership probe: (N, W32) -> (N,) bool."""
        return _bloom_contains(self.words, limbs, self.size_bits,
                               self.n_hash, self.user_seed, self.kind,
                               self.kmer_size)

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.words)


BLOCK_NBITS = 12  # BloomCacheCoherent block size (Bloom.hpp:437)

# canonical (first_nt, last_nt) pair table of BloomNeighborCoherent
# (Bloom.hpp:526-541 cano2[16])
CANO2 = (0, 1, 2, 3, 4, 5, 3, 7, 8, 9, 0, 4, 9, 13, 1, 5)


def _simplehash16(limbs: jnp.ndarray, shift: int, span1: bool) -> U64:
    """Bit-exact port of simplehash16 on the LOW 64-bit word of the kmer.

    Two variants exist in the reference and the choice follows the
    compiled span type of the kmer, NOT a formula:
    - LargeInt<1> (k <= 31, span 32): LargeInt1.pri:190-201 XORs THREE
      RANDOM_VALUES bytes — (key>>shift), (key>>shift+8), and (key&255).
    - every other span: NativeInt64.hpp:211-219 via LargeInt2.pri:248 /
      LargeInt.hpp:792-800 — only the first TWO bytes.
    shift < 10 here (hash index), so all bytes live in the low 32 bits.
    """
    from .bloom_data import RANDOM_VALUES

    assert shift + 16 <= 32, "simplehash16 shift out of low-limb range"
    lo = limbs[:, -1]
    b0 = ((lo >> shift) & jnp.uint32(0xFF)).astype(jnp.int32)
    b1 = ((lo >> (shift + 8)) & jnp.uint32(0xFF)).astype(jnp.int32)
    rv_hi = jnp.asarray([(v >> 32) & 0xFFFFFFFF for v in RANDOM_VALUES],
                        jnp.uint32)
    rv_lo = jnp.asarray([v & 0xFFFFFFFF for v in RANDOM_VALUES], jnp.uint32)
    hi = rv_hi[b0] ^ rv_hi[b1]
    lo_out = rv_lo[b0] ^ rv_lo[b1]
    if span1:
        b2 = (lo & jnp.uint32(0xFF)).astype(jnp.int32)
        hi = hi ^ rv_hi[b2]
        lo_out = lo_out ^ rv_lo[b2]
    return U64(hi, lo_out)


def _neighbor_hashpart(limbs: jnp.ndarray, k: int) -> tuple:
    """(canonical inner (k-2)-mer limbs, cano2 prefix value) of each kmer
    (BloomNeighborCoherent insert/contains, Bloom.hpp:555-575)."""
    from ..ops.kmer_ops import nb_limbs, top_mask, lex_lt
    from ..ops.neighbor_ops import revcomp_limbs

    n, w = limbs.shape
    top_bits = 2 * k - 32 * (w - 1)
    first_nt = (limbs[:, 0] >> (top_bits - 2)) & jnp.uint32(3)
    last_nt = limbs[:, -1] & jnp.uint32(3)
    pref = (first_nt << 2) + last_nt
    cano2 = jnp.asarray(CANO2, jnp.uint32)
    pref_val = cano2[pref.astype(jnp.int32)]
    # hashpart = (v >> 2) & mask_{2(k-2)}
    parts = []
    for j in range(w):
        lo = limbs[:, j] >> 2
        hi = limbs[:, j - 1] << 30 if j > 0 else jnp.zeros_like(lo)
        parts.append(hi | lo)
    hp = jnp.stack(parts, axis=-1)
    wk2 = nb_limbs(k - 2)
    if wk2 < w:
        hp = hp[:, w - wk2:]
    hp = hp.at[:, 0].set(hp[:, 0] & jnp.uint32(top_mask(k - 2)))
    rc = revcomp_limbs(hp, k - 2)
    hp = jnp.where(lex_lt(hp, rc)[:, None], hp, rc)
    return hp, pref_val


@functools.partial(jax.jit, static_argnames=("size_bits", "n_hash", "seed",
                                              "kind", "kmer_size"))
def _bloom_positions(limbs, size_bits: int, n_hash: int, seed: int,
                     kind: str = "basic", kmer_size: int = 0):
    seeds = bloom_seeds(seed)
    if kind == "basic":
        pos = []
        for i in range(n_hash):
            h = _chunk_hash(limbs, seeds[i])
            pos.append(u64_mod_u32(h, size_bits))
        return jnp.stack(pos, axis=-1)  # (N, n_hash) uint32
    mask_block = jnp.uint32((1 << BLOCK_NBITS) - 1)
    # the simplehash16 variant follows the compiled span type of the item:
    # LargeInt<1> (k <= 31 with KSIZE_LIST 32/64/96/128) uses the 3-byte mix
    span1 = 0 < kmer_size <= 31
    if kind == "neighbor":
        # BloomNeighborCoherent (Bloom.hpp:514-640): hash the canonical
        # inner (k-2)-mer, offset h0 by the cano2 (first,last)-nt value —
        # a kmer and its neighbors share the same 2^12-bit block
        hp, pref_val = _neighbor_hashpart(limbs, kmer_size)
        h0 = u64_mod_u32(_chunk_hash(hp, seeds[0]), size_bits) + pref_val
        key = hp
    else:
        # cache-coherent (Bloom.hpp:446-497): h0 anywhere, others in-block
        h0 = u64_mod_u32(_chunk_hash(limbs, seeds[0]), size_bits)
        key = limbs
    pos = [h0]
    for i in range(1, n_hash):
        off = _simplehash16(key, i, span1).lo & mask_block
        pos.append(h0 + off)
    return jnp.stack(pos, axis=-1)


def _bloom_nwords(size_bits: int, kind: str) -> int:
    pad = 2 * (1 << BLOCK_NBITS) if kind in ("cache", "neighbor") else 0
    return (size_bits + pad + 31) // 32


@functools.partial(jax.jit, static_argnames=("size_bits", "n_hash", "seed",
                                              "kind", "kmer_size"))
def _bloom_build(limbs, valid, size_bits: int, n_hash: int, seed: int,
                 kind: str = "basic", kmer_size: int = 0):
    pos = _bloom_positions(limbs, size_bits, n_hash, seed, kind, kmer_size)
    n_words = _bloom_nwords(size_bits, kind)
    nbits = n_words * 32
    pos = jnp.where(valid[:, None], pos, jnp.uint32(nbits))
    bits = jnp.zeros((nbits,), jnp.bool_)
    bits = bits.at[pos.reshape(-1)].set(True, mode="drop")
    # pack bool bits -> uint32 words
    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))
    words = jnp.sum(bits.reshape(n_words, 32).astype(jnp.uint32)
                    * weights[None, :], axis=1, dtype=jnp.uint32)
    return words


@functools.partial(jax.jit, static_argnames=("size_bits", "n_hash", "seed",
                                              "kind", "kmer_size"))
def _bloom_contains(words, limbs, size_bits: int, n_hash: int, seed: int,
                    kind: str = "basic", kmer_size: int = 0):
    pos = _bloom_positions(limbs, size_bits, n_hash, seed, kind, kmer_size)
    w = words[pos >> 5]
    bit = (w >> (pos & 31)) & 1
    return jnp.all(bit == 1, axis=-1)


def build_bloom(limbs: jnp.ndarray, valid: jnp.ndarray | None = None, *,
                nbits_per_kmer: float = 12.0, nb_items: int | None = None,
                user_seed: int = 0, kind: str = "basic",
                kmer_size: int = 0) -> BloomFilter:
    """Build a bloom over a set of kmers (BloomAlgorithm equivalent,
    kmer/impl/BloomAlgorithm.cpp:155-203). kind: 'basic', 'cache', or
    'neighbor' (the graph-build default; requires kmer_size)."""
    if kind in ("cache-coherent", "default"):
        kind = "cache"
    if kind not in ("basic", "cache", "neighbor"):
        raise ValueError(f"unknown bloom kind {kind!r}")
    if kind == "neighbor" and kmer_size < 3:
        raise ValueError("neighbor bloom needs kmer_size >= 3")
    if valid is None:
        valid = jnp.ones((limbs.shape[0],), jnp.bool_)
    if nb_items is None:
        nb_items = int(jnp.sum(valid))
    size_bits, n_hash = optimal_params(nb_items, nbits_per_kmer)
    words = _bloom_build(limbs, valid, size_bits, n_hash, user_seed, kind,
                         kmer_size)
    return BloomFilter(words, size_bits, n_hash, user_seed, kind, kmer_size)


# NBITS_PER_KMER formula used by debloom (DebloomAlgorithm.cpp:628-650);
# the C function returns a float, so the value is rounded through float32
def debloom_nbits_per_kmer(kmer_size: int, cascading: bool) -> float:
    import math

    if cascading:
        if kmer_size > 128:
            raise ValueError(
                f"kmer size {kmer_size} too big for cascading bloom filters")
        from .bloom_data import CASCADING_NBITS

        v = CASCADING_NBITS[kmer_size]
    else:
        lg2 = math.log(2)
        v = math.log(16 * kmer_size * (lg2 * lg2)) / (lg2 * lg2)
    v = float(np.float32(v))
    return v if v != 0 else 1.0
