"""Vectorized 64-bit unsigned arithmetic emulated with uint32 (hi, lo) pairs.

JAX supports 64-bit integers only under the global x64 flag. The framework therefore represents every 64-bit
quantity (hash values, Bloom indices, kmer words) as a pair of uint32 arrays
``(hi, lo)``. All ops below are elementwise and shape-polymorphic, and are
bit-exact matches of C uint64_t semantics (wrap-around on overflow).

Used to port the reference hash functions bit-for-bit:
  - hash64   (gatb-core: src/gatb/tools/math/NativeInt64.hpp:175-188)
  - oahash64 (gatb-core: src/gatb/tools/math/NativeInt64.hpp:191-203)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

_U32 = jnp.uint32
_MASK16 = jnp.uint32(0xFFFF)


class U64(NamedTuple):
    """An array of 64-bit unsigned ints as two uint32 arrays (hi, lo)."""

    hi: jnp.ndarray
    lo: jnp.ndarray

    @staticmethod
    def from_int(value: int, like=None) -> "U64":
        hi = jnp.uint32((value >> 32) & 0xFFFFFFFF)
        lo = jnp.uint32(value & 0xFFFFFFFF)
        if like is not None:
            hi = jnp.full_like(like, hi, dtype=_U32)
            lo = jnp.full_like(like, lo, dtype=_U32)
        return U64(hi, lo)

    @staticmethod
    def from_u32(lo: jnp.ndarray) -> "U64":
        lo = lo.astype(_U32)
        return U64(jnp.zeros_like(lo), lo)


def u64_xor(a: U64, b: U64) -> U64:
    return U64(a.hi ^ b.hi, a.lo ^ b.lo)


def u64_not(a: U64) -> U64:
    return U64(~a.hi, ~a.lo)


def u64_add(a: U64, b: U64) -> U64:
    lo = a.lo + b.lo
    carry = (lo < a.lo).astype(_U32)
    hi = a.hi + b.hi + carry
    return U64(hi, lo)


def u64_shl(a: U64, n: int) -> U64:
    """Left shift by a static amount 0 <= n < 64."""
    if n == 0:
        return a
    if n >= 32:
        return U64((a.lo << (n - 32)) if n > 32 else a.lo, jnp.zeros_like(a.lo))
    return U64((a.hi << n) | (a.lo >> (32 - n)), a.lo << n)


def u64_shr(a: U64, n: int) -> U64:
    """Logical right shift by a static amount 0 <= n < 64."""
    if n == 0:
        return a
    if n >= 32:
        return U64(jnp.zeros_like(a.hi), (a.hi >> (n - 32)) if n > 32 else a.hi)
    return U64(a.hi >> n, (a.lo >> n) | (a.hi << (32 - n)))


def _mul32_wide(a: jnp.ndarray, b: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full 32x32 -> 64 multiply returning (hi32, lo32), via 16-bit halves."""
    a = a.astype(_U32)
    b = b.astype(_U32)
    al, ah = a & _MASK16, a >> 16
    bl, bh = b & _MASK16, b >> 16
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    # carry of the middle column
    mid = (ll >> 16) + (lh & _MASK16) + (hl & _MASK16)
    lo = (ll & _MASK16) | (mid << 16)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def u64_mul(a: U64, b: U64) -> U64:
    """64x64 -> low 64 bits multiply (C uint64_t semantics)."""
    hi, lo = _mul32_wide(a.lo, b.lo)
    hi = hi + a.lo * b.hi + a.hi * b.lo  # mod 2^32 contributions
    return U64(hi, lo)


def u64_eq(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi == b.hi) & (a.lo == b.lo)


def u64_lt(a: U64, b: U64) -> jnp.ndarray:
    return (a.hi < b.hi) | ((a.hi == b.hi) & (a.lo < b.lo))


def u64_sub(a: U64, b: U64) -> U64:
    """a - b with C uint64_t wrap-around semantics."""
    lo = a.lo - b.lo
    borrow = (a.lo < b.lo).astype(_U32)
    hi = a.hi - b.hi - borrow
    return U64(hi, lo)


def u64_mulhi(a: U64, bh: int, bl: int) -> U64:
    """High 64 bits of the 64x64->128 product a * (bh*2^32 + bl), where
    (bh, bl) is a STATIC 64-bit constant. Exact (full 128-bit schoolbook
    with carry propagation through the middle column)."""
    bh_c = jnp.uint32(bh)
    bl_c = jnp.uint32(bl)
    t_hi, _ = _mul32_wide(a.lo, bl_c)            # al*bl: only hi32 matters
    u = U64(*_mul32_wide(a.lo, bh_c))            # al*bh (64-bit)
    v = U64(*_mul32_wide(a.hi, bl_c))            # ah*bl (64-bit)
    w = U64(*_mul32_wide(a.hi, bh_c))            # ah*bh (64-bit)
    # mid = u + v + t_hi, tracking carries past bit 64
    s1 = u64_add(u, v)
    c1 = u64_lt(s1, u).astype(_U32)              # carry of u+v
    s2 = u64_add(s1, U64.from_u32(t_hi))
    c2 = u64_lt(s2, s1).astype(_U32)             # carry of +t_hi
    # hi128 = w + (mid >> 32) + carries*2^32
    out = u64_add(w, U64(jnp.zeros_like(s2.hi), s2.hi))
    return u64_add(out, U64(c1 + c2, jnp.zeros_like(c1)))


def u64_mod_u32(a: U64, m: int) -> jnp.ndarray:
    """a mod m for a static modulus 1 <= m < 2^32. Returns uint32. Exact
    for the full u64 input range (Barrett reduction with the static
    64-bit reciprocal floor(2^64/m); quotient error <= 2, corrected).
    """
    if not (1 <= m < (1 << 32)):
        raise ValueError(f"u64_mod_u32: modulus {m} out of range")
    if m == 1:
        return jnp.zeros_like(a.lo)
    if m & (m - 1) == 0:  # power of two
        return a.lo & jnp.uint32(m - 1)
    recip = (1 << 64) // m  # < 2^64 since m >= 2
    q = u64_mulhi(a, (recip >> 32) & 0xFFFFFFFF, recip & 0xFFFFFFFF)
    r = u64_sub(a, u64_mul(q, U64.from_int(m, like=a.lo)))
    m64 = U64.from_int(m, like=a.lo)
    for _ in range(2):  # q underestimates floor(a/m) by at most 2
        over = ~u64_lt(r, m64)
        r = U64(jnp.where(over, u64_sub(r, m64).hi, r.hi),
                jnp.where(over, u64_sub(r, m64).lo, r.lo))
    return r.lo


# ---------------------------------------------------------------------------
# Reference hash functions (bit-exact ports)
# ---------------------------------------------------------------------------


def hash64(key: U64, seed: U64) -> U64:
    """Bit-exact port of NativeInt64::hash64 (NativeInt64.hpp:175-188)."""
    hash_ = seed
    # hash ^= (hash << 7) ^ key * (hash >> 3) ^ ~((hash << 11) + (key ^ (hash >> 5)))
    t1 = u64_shl(hash_, 7)
    t2 = u64_mul(key, u64_shr(hash_, 3))
    t3 = u64_not(u64_add(u64_shl(hash_, 11), u64_xor(key, u64_shr(hash_, 5))))
    hash_ = u64_xor(hash_, u64_xor(t1, u64_xor(t2, t3)))
    # hash = (~hash) + (hash << 21)
    hash_ = u64_add(u64_not(hash_), u64_shl(hash_, 21))
    hash_ = u64_xor(hash_, u64_shr(hash_, 24))
    # hash = (hash + (hash << 3)) + (hash << 8)
    hash_ = u64_add(u64_add(hash_, u64_shl(hash_, 3)), u64_shl(hash_, 8))
    hash_ = u64_xor(hash_, u64_shr(hash_, 14))
    # hash = (hash + (hash << 2)) + (hash << 4)
    hash_ = u64_add(u64_add(hash_, u64_shl(hash_, 2)), u64_shl(hash_, 4))
    hash_ = u64_xor(hash_, u64_shr(hash_, 28))
    hash_ = u64_add(hash_, u64_shl(hash_, 31))
    return hash_


def oahash64(elem: U64) -> U64:
    """Bit-exact port of NativeInt64::oahash64 (NativeInt64.hpp:191-203)."""
    code = elem
    code = u64_xor(code, u64_shr(code, 14))
    code = u64_add(u64_not(code), u64_shl(code, 18))
    code = u64_xor(code, u64_shr(code, 31))
    code = u64_mul(code, U64.from_int(21, like=code.lo))
    code = u64_xor(code, u64_shr(code, 11))
    code = u64_add(code, u64_shl(code, 6))
    code = u64_xor(code, u64_shr(code, 22))
    return code
