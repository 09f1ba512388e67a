"""Device-side k-mer extraction: rolling canonical k-mers + minimizers.

K-mers are represented as arrays of uint32 *limbs* in big-endian limb order
(most-significant limb first), ``W = ceil(2k/32)`` limbs per k-mer. With that
layout, lexicographic comparison over the limb axis equals integer comparison
of the underlying 2k-bit value, which is exactly gatb-core's LargeInt order
(LargeInt.hpp operator<) — so multi-key sorts reproduce reference sort order
for every k, with no 64-bit integer arithmetic.

Semantics matched bit-for-bit with gatb-core:
  - rolling forward update  v = ((v << 2) + c) & mask     (Model.hpp:824)
  - rolling revcomp update  r = (r >> 2) + rc(c)<<2(k-1)  (Model.hpp:936-944)
  - canonical = min(fwd, rev) as integers                 (Model.hpp:218-295)
  - k-mer valid iff its k nucleotides are all valid       (Model.hpp:725-770)
  - minimizer = min over m-mer windows of LUT(mmer) where
    LUT(x) = canon(x) if allowed else 4^m-1               (Model.hpp:1040-1065)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .bitpack import mmer_allowed, revcomp_u32

U32 = jnp.uint32


def nb_limbs(k: int) -> int:
    """Number of uint32 limbs for a k-mer (ceil(2k/32))."""
    return (2 * k + 31) // 32


def top_mask(k: int) -> int:
    bits = (2 * k) % 32
    return 0xFFFFFFFF if bits == 0 else (1 << bits) - 1


def lex_lt(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lexicographic a < b over the last (limb) axis. Big-endian limbs."""
    w = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], dtype=bool)
    eq = jnp.ones(a.shape[:-1], dtype=bool)
    for j in range(w):
        aj, bj = a[..., j], b[..., j]
        lt = lt | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return lt


def lex_eq(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return jnp.all(a == b, axis=-1)


class KmerBatch(NamedTuple):
    """Extracted canonical k-mers for a padded batch of reads.

    kmers: (B, P, W) uint32 canonical k-mer limbs (garbage where invalid)
    valid: (B, P) bool — True iff all k bases of the window are ACGT and the
           window lies inside the read (P = L - k + 1 window positions)
    minimizer: (B, P) uint32 — LUT-mapped minimizer value of each k-mer
           (4^m - 1 when every m-mer of the window is banned)
    """

    kmers: jnp.ndarray
    valid: jnp.ndarray
    minimizer: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("k", "m", "with_minimizers"))
def extract_kmers(codes: jnp.ndarray, valid: jnp.ndarray, lengths: jnp.ndarray,
                  k: int, m: int = 10,
                  freq_order: jnp.ndarray | None = None,
                  with_minimizers: bool = True) -> KmerBatch:
    """Extract canonical k-mers + minimizers from a padded code batch.

    codes:   (B, L) uint8/int 2-bit codes (padding may be any value)
    valid:   (B, L) bool per-character validity (padding must be False)
    lengths: (B,) int32 true read lengths

    Fully parallel (no sequential scan): codes are packed 16-per-uint32,
    and each window's limbs are funnel-shifted out of the packed stream,
    grouped by the 16 possible bit offsets. Reverse complements come from
    the vectorized revcomp of the forward limbs. O(1) depth — maps onto
    the VPU with no loop-carried dependency, and compiles to a small HLO
    (the old scan unrolled L steps).
    """
    B, L = codes.shape
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    P = L - k + 1
    fwds = _window_limbs(codes, k)  # (B, P, W)
    revs = revcomp_limbs_(fwds, k)
    canon = jnp.where(lex_lt(fwds, revs)[..., None], fwds, revs)

    # --- validity: all k chars valid and window inside read ------------
    inval = (~valid).astype(jnp.int32)
    cum = jnp.cumsum(inval, axis=1)
    cum = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cum], axis=1)
    window_bad = cum[:, k:] - cum[:, :P]
    pos = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    inside = pos + k <= lengths[:, None]
    kvalid = (window_bad == 0) & inside

    # --- minimizers ----------------------------------------------------
    # single-pass single-device counting never consumes them; skipping
    # saves the windowed-min sweep + m-mer canonicalization per batch
    if with_minimizers:
        minim = _minimizers(codes, k, m, freq_order)  # (B, P)
    else:
        minim = None

    return KmerBatch(canon, kvalid, minim)


@functools.partial(jax.jit,
                   static_argnames=("k", "L", "m", "with_minimizers"))
def extract_kmers_packed(words: jnp.ndarray, vmask: jnp.ndarray,
                         lengths: jnp.ndarray, k: int, L: int, m: int = 10,
                         freq_order: jnp.ndarray | None = None,
                         with_minimizers: bool = True) -> KmerBatch:
    """extract_kmers over the packed transfer format (pack_words/
    pack_valid): words (B, ceil(L/16)) uint32, vmask (B, ceil(L/32)).

    The limb extraction consumes the packed words directly (they ARE the
    internal stream _window_limbs builds), so the device never
    materializes byte codes unless minimizers are requested.

    ``vmask=None`` declares every in-length base valid (the dense
    transfer mode, r5): a clean bank's all-ones masks are ~1/3 of the
    packed upload, so the host sends None and
    window validity reduces to the in-read position check."""
    B = words.shape[0]
    if L < k:
        raise ValueError(f"padded length {L} < k={k}")
    P = L - k + 1
    fwds = _window_limbs_from_words(words, L, k)
    revs = revcomp_limbs_(fwds, k)
    canon = jnp.where(lex_lt(fwds, revs)[..., None], fwds, revs)

    pos = jax.lax.broadcasted_iota(jnp.int32, (B, P), 1)
    inside = pos + k <= lengths[:, None]
    if vmask is None:        # dense mode: in-length bases are all valid
        kvalid = inside
    else:
        valid = unpack_valid(vmask, L)
        inval = (~valid).astype(jnp.int32)
        cum = jnp.cumsum(inval, axis=1)
        cum = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), cum],
                              axis=1)
        window_bad = cum[:, k:] - cum[:, :P]
        kvalid = (window_bad == 0) & inside

    if with_minimizers:
        minim = _minimizers(unpack_codes(words, L), k, m, freq_order)
    else:
        minim = None
    return KmerBatch(canon, kvalid, minim)


def pack_words(codes: jnp.ndarray) -> jnp.ndarray:
    """Pack (B, L) 2-bit codes 16-per-uint32, first code in the MSBs.

    The packed-word stream is the transfer format of the production
    driver: 2 bits/base over the host->device link instead of 8.
    """
    B, L = codes.shape
    pad = (-L) % 16
    c = codes.astype(U32)
    if pad:
        c = jnp.concatenate([c, jnp.zeros((B, pad), U32)], axis=1)
    cw = c.reshape(B, -1, 16)
    shifts = (30 - 2 * jnp.arange(16, dtype=U32))[None, None, :]
    return jnp.sum(cw << shifts, axis=2, dtype=U32)


def pack_valid(valid: jnp.ndarray) -> jnp.ndarray:
    """Pack (B, L) validity bools 32-per-uint32, first position at bit 31."""
    B, L = valid.shape
    pad = (-L) % 32
    v = valid.astype(U32)
    if pad:
        v = jnp.concatenate([v, jnp.zeros((B, pad), U32)], axis=1)
    vw = v.reshape(B, -1, 32)
    shifts = (31 - jnp.arange(32, dtype=U32))[None, None, :]
    return jnp.sum(vw << shifts, axis=2, dtype=U32)


def unpack_valid(vmask: jnp.ndarray, L: int) -> jnp.ndarray:
    """(B, ceil(L/32)) uint32 -> (B, L) bool (inverse of pack_valid)."""
    B = vmask.shape[0]
    shifts = (31 - jnp.arange(32, dtype=U32))[None, None, :]
    bits = (vmask[:, :, None] >> shifts) & U32(1)
    return bits.reshape(B, -1)[:, :L] != 0


def unpack_codes(words: jnp.ndarray, L: int) -> jnp.ndarray:
    """(B, ceil(L/16)) uint32 -> (B, L) uint8 codes (inverse of pack_words)."""
    B = words.shape[0]
    shifts = (30 - 2 * jnp.arange(16, dtype=U32))[None, None, :]
    c = (words[:, :, None] >> shifts) & U32(3)
    return c.reshape(B, -1)[:, :L].astype(jnp.uint8)


def _window_limbs(codes: jnp.ndarray, k: int) -> jnp.ndarray:
    """Forward k-mer limbs for every window position, scan-free.

    Packs codes 16-per-uint32 (first code in the MSBs), then extracts each
    limb as 32 bits at stream offset ``2*i + 2k - 32*(W-j)`` via funnel
    shifts, vectorized over the 16 offset classes of window positions.
    """
    return _window_limbs_from_words(pack_words(codes), codes.shape[1], k)


def _window_limbs_from_words(pw0: jnp.ndarray, L: int, k: int) -> jnp.ndarray:
    """Forward k-mer limbs for every window from packed 16-code words."""
    B = pw0.shape[0]
    w = nb_limbs(k)
    P = L - k + 1
    # number of 16-code words needed, padded so every extract stays in range
    nq_out = (P + 15) // 16
    n_words = (L + 15) // 16 + w + 1
    pad_w = n_words - pw0.shape[1]
    pw = pw0 if pad_w <= 0 else jnp.concatenate(
        [pw0, jnp.zeros((B, pad_w), U32)], axis=1)

    def extract32(word_idx_base: int, bit: int, nq: int):
        """32 bits at stream offset 32*word_idx_base + bit for nq starts."""
        a = pw[:, word_idx_base:word_idx_base + nq]
        if bit == 0:
            return a
        b = pw[:, word_idx_base + 1:word_idx_base + 1 + nq]
        return (a << bit) | (b >> (32 - bit))

    top_bits = 2 * k - 32 * (w - 1)  # significant bits in limb 0 (1..32)
    mask0 = U32(top_mask(k))
    per_offset = []  # o -> (nq, W) limbs
    for o in range(16):
        limbs_o = []
        for j in range(w):
            # stream offset of limb j for window start i=16q+o:
            #   2i + 2k - 32*(w - j)  (negative part masked for j=0)
            off = 2 * o + 2 * k - 32 * (w - j)
            if off >= 0:
                wi, bit = off // 32, off % 32
                e = extract32(wi, bit, nq_out)
            else:
                # limb 0 with 2k < 32w: take bits starting at 2o, shifted
                # right so the value is right-aligned in the limb
                wi, bit = (2 * o) // 32, (2 * o) % 32
                e = extract32(wi, bit, nq_out) >> (32 - top_bits)
            if j == 0:
                e = e & mask0
            limbs_o.append(e)
        per_offset.append(jnp.stack(limbs_o, axis=-1))  # (B, nq, W)
    # interleave: arr[b, q, o, w] -> position 16q + o
    allw = jnp.stack(per_offset, axis=2)  # (B, nq, 16, W)
    allw = allw.reshape(B, nq_out * 16, w)
    return allw[:, :P]


def revcomp_limbs_(limbs: jnp.ndarray, k: int) -> jnp.ndarray:
    from .neighbor_ops import revcomp_limbs as _rc

    return _rc(limbs, k)


def _minimizers(codes: jnp.ndarray, k: int, m: int,
                freq_order: jnp.ndarray | None = None) -> jnp.ndarray:
    """Per-kmer minimizer values (windowed min of LUT-mapped m-mers).

    With ``freq_order`` ((4^m,) uint32 frequency ranks), minimizers are
    chosen by (rank, value) order and the banned-AA rule is disabled
    (ComparatorMinimizerFrequencyOrLex, Model.hpp:911-980: every
    minimizer is allowed in freq mode).
    """
    B, L = codes.shape
    P = L - k + 1
    nmm = L - m + 1
    # m-mer value at each position: polynomial of m consecutive codes.
    mm = jnp.zeros((B, nmm), U32)
    for i in range(m):
        mm = (mm << 2) | codes[:, i:i + nmm].astype(U32)
    # LUT semantics (Model.hpp:1040-1065): canonicalize then ban.
    rc = revcomp_u32(mm, m)
    canon = jnp.minimum(mm, rc)
    nwin = k - m + 1
    if freq_order is None:
        mask_m = U32((1 << (2 * m)) - 1)
        lutv = jnp.where(mmer_allowed(canon, m), canon, mask_m)
        # windowed min over the k-m+1 m-mers of each k-mer window
        out = lutv[:, 0:P]
        for i in range(1, nwin):
            out = jnp.minimum(out, lutv[:, i:i + P])
        return out
    ranks = freq_order[canon.astype(jnp.int32)].astype(U32)
    best_r = ranks[:, 0:P]
    best_v = canon[:, 0:P]
    for i in range(1, nwin):
        r = ranks[:, i:i + P]
        v = canon[:, i:i + P]
        better = (r < best_r) | ((r == best_r) & (v < best_v))
        best_r = jnp.where(better, r, best_r)
        best_v = jnp.where(better, v, best_v)
    return best_v


def kmers_to_py(limbs) -> list[int]:
    """Convert (N, W) uint32 limb array to Python ints (host/debug)."""
    import numpy as np

    limbs = np.asarray(limbs, dtype=np.uint64)
    n, w = limbs.shape
    out = np.zeros(n, dtype=object)
    for j in range(w):
        out = (out * (1 << 32)) + limbs[:, j]
    return list(out)


def py_to_limbs(values, k: int):
    """Convert iterable of Python ints to (N, W) uint32 limb array."""
    import numpy as np

    w = nb_limbs(k)
    vals = list(values)
    out = np.zeros((len(vals), w), dtype=np.uint32)
    for i, v in enumerate(vals):
        for j in range(w - 1, -1, -1):
            out[i, j] = v & 0xFFFFFFFF
            v >>= 32
    return out
