"""Sort / unique / segment-reduce primitives over limb-array k-mer keys.

These replace gatb-core's radix-array + 453-way-merge counting kernel
(kmer/impl/PartitionsCommand.cpp:1206-1800) with a sort-based recipe:
multi-key sort (XLA `lax.sort` with num_keys = 1 flag + W limbs)
followed by run detection + segment-sum. All shapes are static; invalid
slots are pushed to the tail by a leading validity key.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

U32 = jnp.uint32
I32 = jnp.int32


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _lex_lt_limbs(a, b):
    """a < b lexicographically over tuples of same-shape uint32 limb
    planes (big-endian limb order == integer order)."""
    lt = jnp.zeros(a[0].shape, bool)
    eq = jnp.ones(a[0].shape, bool)
    for aj, bj in zip(a, b):
        lt = lt | (eq & (aj < bj))
        eq = eq & (aj == bj)
    return lt


def _merge_sorted_runs(limbs, run: int):
    """Bitonic merge level as elementwise stages: pairs of adjacent
    ascending runs of length ``run`` -> compare-exchange stages j = run,
    run/2, ..., 1, leaving ascending runs of 2*run. Pure elementwise ops
    over a (pairs, blocks, 2, j) strided view, no sort; all planes are
    keys (payload planes ride as least-significant keys).
    """
    n = limbs[0].shape[0]
    pairs = n // (2 * run)
    # second run of each pair reversed -> bitonic sequence of length 2*run
    xs = []
    for x in limbs:
        v = x.reshape(pairs, 2, run)
        xs.append(jnp.concatenate([v[:, 0], v[:, 1, ::-1]], axis=1))
    j = run
    while j >= 1:
        ys = [x.reshape(pairs, (2 * run) // (2 * j), 2, j) for x in xs]
        a = tuple(y[:, :, 0] for y in ys)
        b = tuple(y[:, :, 1] for y in ys)
        lt = _lex_lt_limbs(a, b)
        xs = []
        for aj, bj in zip(a, b):
            lo = jnp.where(lt, aj, bj)
            hi = jnp.where(lt, bj, aj)
            xs.append(jnp.stack([lo, hi], axis=2).reshape(pairs, 2 * run))
        j //= 2
    return tuple(x.reshape(n) for x in xs)


class CountTable(NamedTuple):
    """Fixed-capacity sorted table of distinct k-mers with counts.

    kmers:  (C, W) uint32 limbs, ascending integer order; rows >= n are padding
    counts: (C,) int32 abundances (0 on padding rows)
    n:      () int32 number of live rows
    """

    kmers: jnp.ndarray
    counts: jnp.ndarray
    n: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.kmers.shape[0]

    @property
    def width(self) -> int:
        return self.kmers.shape[1]


def sort_by_kmer(kmers: jnp.ndarray, invalid: jnp.ndarray, *payloads):
    """Sort rows by (invalid, kmer) ascending; invalid rows go to the tail.

    kmers: (N, W); invalid: (N,) bool; payloads: extra (N,)/(N,...) arrays
    reordered alongside. Returns (kmers, invalid, *payloads) sorted.
    """
    n, w = kmers.shape
    keys = [invalid.astype(U32)] + [kmers[:, j] for j in range(w)]
    flat_payloads = []
    for p in payloads:
        if p.ndim == 1:
            flat_payloads.append(p)
        else:
            raise ValueError("payloads must be rank-1")
    out = jax.lax.sort(tuple(keys) + tuple(flat_payloads), num_keys=w + 1)
    inv = out[0].astype(bool)
    sorted_kmers = jnp.stack(out[1:w + 1], axis=-1)
    return (sorted_kmers, inv) + tuple(out[w + 1:])


def _run_starts(sorted_kmers: jnp.ndarray, inv: jnp.ndarray) -> jnp.ndarray:
    """Boolean mask of first element of each distinct-valid-kmer run."""
    neq_prev = jnp.any(sorted_kmers[1:] != sorted_kmers[:-1], axis=-1)
    starts = jnp.concatenate([jnp.ones((1,), bool), neq_prev])
    return starts & ~inv


def count_sorted(sorted_kmers: jnp.ndarray, inv: jnp.ndarray,
                 weights: jnp.ndarray | None = None) -> CountTable:
    """Reduce a sorted (kmer, invalid) stream into a CountTable.

    weights defaults to 1 per valid row (raw occurrence counting); pass
    existing counts when merging tables.
    """
    cap, w = sorted_kmers.shape
    starts = _run_starts(sorted_kmers, inv)
    if weights is None:
        weights = jnp.ones((cap,), I32)
    weights = jnp.where(inv, 0, weights.astype(I32))
    run_id = jnp.cumsum(starts.astype(I32)) - 1  # id of each row's run
    seg_id = jnp.where(inv, cap - 1, run_id).astype(I32)
    counts = jax.ops.segment_sum(weights, seg_id, num_segments=cap)
    n = jnp.sum(starts).astype(I32)
    # Compact: scatter run-start rows to their run_id position; non-start
    # rows are sent out of bounds and dropped.
    dest = jnp.where(starts, run_id, cap).astype(I32)
    uniq = jnp.full_like(sorted_kmers, U32(0xFFFFFFFF))
    uniq = uniq.at[dest].set(sorted_kmers, mode="drop")
    # counts for padding rows must be 0: mask beyond n
    idx = jax.lax.broadcasted_iota(I32, (cap,), 0)
    counts = jnp.where(idx < n, counts, 0)
    return CountTable(uniq, counts, n)


@functools.partial(jax.jit, static_argnames=("spare_bits",))
def count_batch(kmers: jnp.ndarray, valid: jnp.ndarray,
                spare_bits: bool = False) -> CountTable:
    """Flatten, sort, and reduce one extracted batch into a CountTable.

    With ``spare_bits=True`` (top limb has unused high bits, i.e.
    2k % 32 != 0), invalid rows are encoded as the all-ones sentinel —
    which no valid kmer can equal — and the sort drops the extra
    validity key, cutting one u32 key from the sort.
    """
    flat = kmers.reshape(-1, kmers.shape[-1])
    inv = ~valid.reshape(-1)
    n_valid = jnp.sum(valid)
    if spare_bits:
        flat = jnp.where(inv[:, None], U32(0xFFFFFFFF), flat)
        w = flat.shape[1]
        out = jax.lax.sort(tuple(flat[:, j] for j in range(w)), num_keys=w)
        sk = jnp.stack(out, axis=-1)
        idx = jax.lax.broadcasted_iota(I32, (sk.shape[0],), 0)
        si = idx >= n_valid
        return count_sorted(sk, si)
    sk, si = sort_by_kmer(flat, inv)
    return count_sorted(sk, si)


@functools.partial(jax.jit)
def merge_tables(a: CountTable, b: CountTable) -> CountTable:
    """Merge two sorted count tables (capacity = cap_a + cap_b)."""
    kmers = jnp.concatenate([a.kmers, b.kmers], axis=0)
    counts = jnp.concatenate([a.counts, b.counts], axis=0)
    cap = kmers.shape[0]
    idx = jax.lax.broadcasted_iota(I32, (cap,), 0)
    live = jnp.concatenate([jnp.arange(a.capacity) < a.n,
                            jnp.arange(b.capacity) < b.n])
    inv = ~live
    sk, si, sc = sort_by_kmer(kmers, inv, counts)
    return count_sorted(sk, si, weights=sc)


def _lex_lt_last(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Lex a <= ordering helper: a < b over the last (limb) axis."""
    w = a.shape[-1]
    lt = jnp.zeros(a.shape[:-1], bool)
    eq = jnp.ones(a.shape[:-1], bool)
    for j in range(w):
        lt = lt | (eq & (a[..., j] < b[..., j]))
        eq = eq & (a[..., j] == b[..., j])
    return lt


def bitonic_merge_pair(ka, ca, kb, cb):
    """Merge two *sorted* (C, W)+counts tables into a sorted (2C, W).

    A bitonic MERGE is log2(2C) elementwise compare-exchange stages —
    not a full sort. This is what makes the device-side global merge of
    per-batch sorted tables cheap: the reference's 453-way KxmerPointer
    merge heap (PartitionsCommand.cpp:1600-1800) becomes a handful of
    fused min/max passes.
    """
    c_len, w = ka.shape
    kb = kb[::-1]
    cb = cb[::-1]
    k = jnp.concatenate([ka, kb], axis=0)   # bitonic sequence
    c = jnp.concatenate([ca, cb], axis=0)
    n = 2 * c_len
    j = c_len
    while j >= 1:
        k2 = k.reshape(n // (2 * j), 2, j, w)
        c2 = c.reshape(n // (2 * j), 2, j)
        a, b = k2[:, 0], k2[:, 1]
        lt = _lex_lt_last(a, b)[..., None]
        lo = jnp.where(lt, a, b)
        hi = jnp.where(lt, b, a)
        lo_c = jnp.where(lt[..., 0], c2[:, 0], c2[:, 1])
        hi_c = jnp.where(lt[..., 0], c2[:, 1], c2[:, 0])
        k = jnp.stack([lo, hi], axis=1).reshape(n, w)
        c = jnp.stack([lo_c, hi_c], axis=1).reshape(n)
        j //= 2
    return k, c


@functools.partial(jax.jit, static_argnames=("spare_bits",))
def merge_stacked_tree(kmers: jnp.ndarray, counts: jnp.ndarray,
                       spare_bits: bool = False) -> CountTable:
    """Device global merge of per-batch *sorted* tables via a bitonic
    merge tree + one final segment reduce.

    kmers: (NB, C, W) sorted tables (padding rows all-ones sentinels when
    spare_bits, else identified by counts == 0), counts: (NB, C).
    Replaces the O(n log^2 n) full re-sort of merge_stacked with
    O(n log n) elementwise merge stages.
    """
    nb, c_len, w = kmers.shape
    flat_c = counts.astype(I32)
    if not spare_bits:
        # encode padding as all-ones keys so they ride to the tail;
        # callers with 2k%32==0 must not produce the all-ones kmer
        live = flat_c > 0
        kmers = jnp.where(live[..., None], kmers, U32(0xFFFFFFFF))
    # pad table length to a power of two (bitonic networks need it);
    # sentinel rows ride to the tail
    c2 = 1
    while c2 < c_len:
        c2 *= 2
    if c2 != c_len:
        pad_k = jnp.full((nb, c2 - c_len, w), U32(0xFFFFFFFF))
        pad_c = jnp.zeros((nb, c2 - c_len), I32)
        kmers = jnp.concatenate([kmers, pad_k], axis=1)
        flat_c = jnp.concatenate([flat_c, pad_c], axis=1)
        c_len = c2
    # pad table count to a power of two with sentinel tables
    nb2 = 1
    while nb2 < nb:
        nb2 *= 2
    if nb2 != nb:
        pad_k = jnp.full((nb2 - nb, c_len, w), U32(0xFFFFFFFF))
        pad_c = jnp.zeros((nb2 - nb, c_len), I32)
        kmers = jnp.concatenate([kmers, pad_k], axis=0)
        flat_c = jnp.concatenate([flat_c, pad_c], axis=0)
    k, c = kmers, flat_c
    while k.shape[0] > 1:
        half = k.shape[0] // 2
        ka, kb = k[0::2], k[1::2]
        ca, cb = c[0::2], c[1::2]
        k, c = jax.vmap(bitonic_merge_pair)(ka, ca, kb, cb)
    k = k[0]
    c = c[0]
    live = c > 0
    n_valid = jnp.sum(live)
    idx = jax.lax.broadcasted_iota(I32, (k.shape[0],), 0)
    si = idx >= n_valid
    return count_sorted(k, si, weights=c)


def _dedup_compact(k: jnp.ndarray, c: jnp.ndarray, cap_out: int):
    """Collapse adjacent equal-key runs (length <= 2) of a sorted table and
    compact live rows to the front of a ``cap_out``-capacity table.

    Requires: k sorted ascending, padding rows have c == 0, and every live
    key appears at most twice (true when merging two distinct-key tables).
    Returns (kmers (cap_out, W), counts (cap_out,), n_live, overflow).
    """
    n, w = k.shape
    live = c > 0
    eq_next = jnp.all(k[1:] == k[:-1], axis=-1) & live[1:] & live[:-1]
    absorb = jnp.concatenate([eq_next, jnp.zeros((1,), bool)])
    c_next = jnp.concatenate([c[1:], jnp.zeros((1,), I32)])
    c = c + jnp.where(absorb, c_next, 0)
    dead = jnp.concatenate([jnp.zeros((1,), bool), eq_next]) | ~live
    idx = jax.lax.broadcasted_iota(I32, (n,), 0)
    # exclusive prefix count of dead rows = shift each live row left past
    # all earlier dead ones (stable compaction)
    dead_i = dead.astype(I32)
    dest = idx - (jnp.cumsum(dead_i) - dead_i)
    n_live = n - jnp.sum(dead_i)
    dest = jnp.where(dead, cap_out, dest)
    out_k = jnp.full((cap_out, w), U32(0xFFFFFFFF))
    out_k = out_k.at[dest].set(k, mode="drop")
    out_c = jnp.zeros((cap_out,), I32).at[dest].set(c, mode="drop")
    return out_k, out_c, n_live, n_live > cap_out


@functools.partial(jax.jit, static_argnames=("cap",))
def merge_stacked_tree_capped(kmers: jnp.ndarray, counts: jnp.ndarray,
                              cap: int):
    """Capacity-bounded device merge of per-batch *distinct-key* tables.

    Same contract as merge_stacked_tree, plus: every input table must have
    distinct keys (count_batch output satisfies this) and the global number
    of distinct kmers must fit in ``cap`` (from the configuration plan's
    distinct-kmer estimate, ConfigurationAlgorithm.cpp:308-319). Each merge
    level dedups equal keys (run length <= 2) and compacts back to <= cap
    rows, so tables stop growing once they reach the cap — the uncapped
    tree's tables double every level and its final segment-reduce touches
    NB*C rows. Returns (CountTable, overflow); on overflow the result is
    invalid and the caller must fall back to merge_stacked_tree.
    """
    nb, c_len, w = kmers.shape
    flat_c = counts.astype(I32)
    live = flat_c > 0
    kmers = jnp.where(live[..., None], kmers, U32(0xFFFFFFFF))
    c2 = _next_pow2(c_len)
    if c2 != c_len:
        kmers = jnp.concatenate(
            [kmers, jnp.full((nb, c2 - c_len, w), U32(0xFFFFFFFF))], axis=1)
        flat_c = jnp.concatenate(
            [flat_c, jnp.zeros((nb, c2 - c_len), I32)], axis=1)
        c_len = c2
    nb2 = _next_pow2(nb)
    if nb2 != nb:
        kmers = jnp.concatenate(
            [kmers, jnp.full((nb2 - nb, c_len, w), U32(0xFFFFFFFF))], axis=0)
        flat_c = jnp.concatenate(
            [flat_c, jnp.zeros((nb2 - nb, c_len), I32)], axis=0)
    k, c = kmers, flat_c
    overflow = jnp.zeros((), bool)
    if k.shape[0] == 1:  # single table: dedup no-op, normalize capacity
        cap_out = min(c_len, _next_pow2(cap))
        k0, c0, _, ov = _dedup_compact(k[0], c[0], cap_out)
        n = jnp.sum(c0 > 0).astype(I32)
        return CountTable(k0, c0, n), overflow | ov
    while k.shape[0] > 1:
        cap_out = min(2 * k.shape[1], _next_pow2(cap))
        mk, mc = jax.vmap(bitonic_merge_pair)(k[0::2], c[0::2],
                                              k[1::2], c[1::2])
        k, c, _, ov = jax.vmap(
            lambda a, b: _dedup_compact(a, b, cap_out))(mk, mc)
        overflow = overflow | jnp.any(ov)
    k, c = k[0], c[0]
    n = jnp.sum(c > 0).astype(I32)
    return CountTable(k, c, n), overflow


@functools.partial(jax.jit, static_argnames=("spare_bits",))
def merge_stacked(kmers: jnp.ndarray, counts: jnp.ndarray,
                  spare_bits: bool = False) -> CountTable:
    """Merge stacked per-batch tables fully on device.

    kmers: (NB, C, W) per-batch sorted tables (padding rows all-ones),
    counts: (NB, C). One global sort + segment reduce; nothing round-trips
    to the host.
    """
    w = kmers.shape[-1]
    flat_k = kmers.reshape(-1, w)
    flat_c = counts.reshape(-1).astype(I32)
    live = flat_c > 0
    if spare_bits:
        flat_k = jnp.where(live[:, None], flat_k, U32(0xFFFFFFFF))
        out = jax.lax.sort(tuple(flat_k[:, j] for j in range(w))
                           + (flat_c,), num_keys=w)
        sk = jnp.stack(out[:w], axis=-1)
        sc = out[w]
        n_valid = jnp.sum(live)
        idx = jax.lax.broadcasted_iota(I32, (flat_k.shape[0],), 0)
        si = idx >= n_valid
    else:
        sk, si, sc = sort_by_kmer(flat_k, ~live, flat_c)
    return count_sorted(sk, si, weights=sc)


# ---------------------------------------------------------------------------
# Plane-major pipeline (round 2): the production counting path.
#
# K-mers ride as tuples of flat (N,) uint32 limb planes instead of (N, W)
# row-major arrays, which keeps every elementwise sort/merge stage on a
# flat layout and avoids the scatter-heavy compaction of count_sorted:
# the reduce below is cumsum/sort only.
# ---------------------------------------------------------------------------


def _run_stats(planes, inv):
    """Shared run detection of a sorted stream: (starts, rid, n, is_end).

    rid = run id per row (nondecreasing); is_end marks each run's last
    valid row. All elementwise/cumsum — no gathers or scatters (a design
    choice tuned on an earlier accelerator; not yet measured on the
    H100).
    """
    neq = planes[0][1:] != planes[0][:-1]
    for p in planes[1:]:
        neq = neq | (p[1:] != p[:-1])
    starts = jnp.concatenate([jnp.ones((1,), bool), neq]) & ~inv
    rid = jnp.cumsum(starts.astype(I32)) - 1
    n = rid[-1] + 1
    next_inv = jnp.concatenate([inv[1:], jnp.ones((1,), bool)])
    next_neq = jnp.concatenate([neq, jnp.ones((1,), bool)])
    is_end = (~inv) & (next_neq | next_inv)
    return starts, rid, n, is_end


def _cumw(inv, weights):
    """Inclusive cumsum of masked weights. Sampled at the run END rows
    (which compact to the table front in run order), adjacent differences
    give per-run totals — runs tile the valid prefix, so
    weight_j = cumw[end_j] - cumw[end_{j-1}]. No segmented scan needed."""
    return jnp.cumsum(jnp.where(inv, 0, weights.astype(I32)))


def _diff_counts(cwe, live):
    prev = jnp.concatenate([jnp.zeros((1,), I32), cwe[:-1]])
    return jnp.where(live, cwe - prev, 0)


def _compact_ends(planes, cumw, is_end, payloads, n, cap_out: int):
    """Move each run's END row (kmer + payload columns) to its run-order
    position: ONE single-key sort keyed on (is_end ? cumw : sentinel).
    cumw at end rows is strictly increasing across runs whenever every
    valid row has weight >= 1 (all callers), so it doubles as the
    run-order key AND the per-run weight sample — no separate rid plane
    rides the sort (round 3: one less plane = ~25% less compaction
    traffic). Stream compaction as a sort rather than a scatter (the
    sort-only rule is not yet re-measured on the H100). Returns
    (out_planes, cwe (int32), out_payloads, live_mask) at cap_out."""
    n_rows = planes[0].shape[0]
    key = jnp.where(is_end, cumw.astype(U32), U32(0xFFFFFFFF))
    sorted_ = jax.lax.sort((key,) + tuple(planes)
                           + tuple(c.astype(U32) for c in payloads),
                           num_keys=1)
    take = min(cap_out, n_rows)
    live_t = jax.lax.broadcasted_iota(I32, (take,), 0) < n

    def fit(x, fill):
        x = jnp.where(live_t, x[:take], fill)
        if take < cap_out:
            x = jnp.concatenate([x, jnp.full((cap_out - take,), fill,
                                             x.dtype)])
        return x

    live = fit(live_t, False) if take < cap_out else live_t
    w = len(planes)
    out_planes = tuple(fit(s, U32(0xFFFFFFFF)) for s in sorted_[1:1 + w])
    cwe = fit(sorted_[0].astype(I32), I32(0))
    out_payloads = tuple(fit(s.astype(I32), I32(0)) for s in sorted_[1 + w:])
    return out_planes, cwe, out_payloads, live


def _compact_ends_blocked(planes, cumw, is_end, payloads, n, cap_out: int,
                          block: int = 4096, margin: int = 3):
    """Two-level compaction of run-END rows (round 3).

    The single-sort compaction (_compact_ends) re-sorts ALL N rows with
    W+1 payload planes — ~40% of counting device time (BASELINE.md). The
    end rows are globally ordered by rid already, so compaction only has
    to close the gaps:
      level 1: batched minor-axis sort of (NB, block) — each block moves
               its end rows to its front (rid order), in one small
               batched sort whose network depth is log^2(block), not log^2(N);
      slice:   keep the first E columns per block (E sized from cap_out
               with a safety margin; a block with more ends than E sets
               the overflow flag);
      level 2: one full sort of only NB*E rows — cumw keys are globally
               unique at ends, so this restores the exact global order.
    Returns (out_planes, cwe, out_payloads, live, overflow_blocked).
    """
    n_rows = planes[0].shape[0]
    nb = n_rows // block
    if nb * block != n_rows or nb < 2:
        out_planes, cwe, out_payloads, live = _compact_ends(
            planes, cumw, is_end, payloads, n, cap_out)
        return out_planes, cwe, out_payloads, live, jnp.zeros((), bool)
    # expected ends per block ~ block * cap_out / N; margin absorbs skew;
    # lane-aligned (multiple of 128), not pow2-rounded
    e_cols = max(128, margin * block * cap_out // n_rows)
    e_cols = min(-(-e_cols // 128) * 128, block)
    key = jnp.where(is_end, cumw.astype(U32), U32(0xFFFFFFFF))
    allp = (key,) + tuple(planes) + tuple(c.astype(U32) for c in payloads)
    shaped = [x.reshape(nb, block) for x in allp]
    ends_per_block = jnp.sum(is_end.reshape(nb, block), axis=1)
    overflow_blocked = jnp.any(ends_per_block > e_cols)
    lvl1 = jax.lax.sort(tuple(shaped), dimension=1, num_keys=1)
    sliced = tuple(x[:, :e_cols].reshape(nb * e_cols) for x in lvl1)
    lvl2 = jax.lax.sort(sliced, num_keys=1)
    take = min(cap_out, nb * e_cols)
    live_t = jax.lax.broadcasted_iota(I32, (take,), 0) < n

    def fit(x, fill):
        x = jnp.where(live_t, x[:take], fill)
        if take < cap_out:
            x = jnp.concatenate([x, jnp.full((cap_out - take,), fill,
                                             x.dtype)])
        return x

    live = fit(live_t, False) if take < cap_out else live_t
    w = len(planes)
    out_planes = tuple(fit(s, U32(0xFFFFFFFF)) for s in lvl2[1:1 + w])
    cwe = fit(lvl2[0].astype(I32), I32(0))
    out_payloads = tuple(fit(s.astype(I32), I32(0)) for s in lvl2[1 + w:])
    return out_planes, cwe, out_payloads, live, overflow_blocked


def count_sorted_planes(planes, inv, weights=None, cap_out: int | None = None,
                        blocked: bool = False):
    """Reduce sorted limb planes into a compacted distinct table.

    planes: tuple of (N,) uint32, sorted ascending by big-endian lex order;
    inv: (N,) bool, True rows must all sit at the tail (sentinel region);
    weights: optional (N,) int32, >= 1 per valid row (defaults to 1) —
    the compaction keys on the weight cumsum, which must strictly
    increase across run ends;
    cap_out: output capacity (default N);
    blocked: use the two-level blocked compaction (_compact_ends_blocked)
    instead of the full-N single-key sort — cheaper whenever the distinct
    ratio is well below 1; a compaction overflow (block skew beyond the
    margin) is folded into the returned overflow flag, and the caller's
    existing bigger-capacity retry resolves it (larger cap_out => larger
    per-block slice).

    Returns (out_planes tuple of (cap_out,), counts (cap_out,), n, overflow).
    Replaces the reference's KxmerPointer merge+CounterBuilder run-length
    loop (PartitionsCommand.cpp:1600-1800) with: run detection + segmented
    carry scans for per-run weights + compaction sorts — scans and sorts
    only, no gathers or scatters.
    """
    n_rows = planes[0].shape[0]
    if cap_out is None:
        cap_out = n_rows
    neq = planes[0][1:] != planes[0][:-1]
    for p in planes[1:]:
        neq = neq | (p[1:] != p[:-1])
    starts = jnp.concatenate([jnp.ones((1,), bool), neq]) & ~inv
    next_inv = jnp.concatenate([inv[1:], jnp.ones((1,), bool)])
    next_neq = jnp.concatenate([neq, jnp.ones((1,), bool)])
    is_end = (~inv) & (next_neq | next_inv)
    n = jnp.sum(starts).astype(I32)
    if weights is None:
        # the contract puts every invalid row at the tail, so the masked
        # cumsum of all-ones weights is min(i+1, n_valid) — elementwise,
        # saving a full-array scan on the hot counting path
        n_valid = (n_rows - jnp.sum(inv)).astype(I32)
        idx = jax.lax.broadcasted_iota(I32, (n_rows,), 0)
        cumw = jnp.minimum(idx + 1, n_valid)
    else:
        cumw = _cumw(inv, weights)
    if blocked:
        out_planes, cwe, _, live, ovb = _compact_ends_blocked(
            planes, cumw, is_end, (), n, cap_out)
        return out_planes, _diff_counts(cwe, live), n, (n > cap_out) | ovb
    out_planes, cwe, _, live = _compact_ends(
        planes, cumw, is_end, (), n, cap_out)
    return out_planes, _diff_counts(cwe, live), n, n > cap_out


def count_sorted_planes_multi(planes, inv, weights_list,
                              cap_out: int | None = None):
    """Multi-weight variant of count_sorted_planes: one run detection,
    per-bank count columns via per-bank segmented carry scans (the
    reference's multibank kmer matrices, PartitionsCommand.cpp:1855-2100,
    in one pass).

    weights_list: tuple of (N,) int32 per-bank weights.
    Returns (out_planes, counts_list tuple of (cap_out,), n, overflow).
    """
    n_rows = planes[0].shape[0]
    if cap_out is None:
        cap_out = n_rows
    starts, _, n, is_end = _run_stats(planes, inv)
    cws = tuple(_cumw(inv, w_) for w_ in weights_list)
    # order key = cumsum of TOTAL weight (>= 1 per valid row, so strictly
    # increasing across run ends); per-bank cumsums ride as payloads
    total_w = weights_list[0].astype(I32)
    for w_ in weights_list[1:]:
        total_w = total_w + w_.astype(I32)
    out_planes, _, cwes, live = _compact_ends(
        planes, _cumw(inv, total_w), is_end, cws, n, cap_out)
    counts_out = tuple(_diff_counts(cwe, live) for cwe in cwes)
    return out_planes, counts_out, n, n > cap_out


@functools.partial(jax.jit, static_argnames=("cap_out",))
def merge_tables_planes_multi(pa, ca_list, na, pb, cb_list, nb,
                              cap_out: int):
    """merge_tables_planes with B per-bank count columns riding the merge
    as extra least-significant key planes (order within equal-kmer runs is
    irrelevant: each column is summed per run downstream)."""
    ca_cap, cb_cap = pa[0].shape[0], pb[0].shape[0]
    if ca_cap != cb_cap:
        cap = max(ca_cap, cb_cap)

        def padto(p_list, c_list):
            padn = cap - p_list[0].shape[0]
            if padn:
                p_list = tuple(jnp.concatenate(
                    [p, jnp.full((padn,), U32(0xFFFFFFFF))]) for p in p_list)
                c_list = tuple(jnp.concatenate(
                    [c.astype(I32), jnp.zeros((padn,), I32)])
                    for c in c_list)
            return p_list, c_list

        pa, ca_list = padto(tuple(pa), tuple(ca_list))
        pb, cb_list = padto(tuple(pb), tuple(cb_list))
    cap = pa[0].shape[0]
    planes = tuple(jnp.concatenate([x, y]) for x, y in zip(pa, pb))
    wts = tuple(jnp.concatenate([x, y]).astype(U32)
                for x, y in zip(ca_list, cb_list))
    merged = jax.lax.sort(planes + wts, num_keys=len(planes) + len(wts))
    w = len(pa)
    idx = jax.lax.broadcasted_iota(I32, (2 * cap,), 0)
    inv = idx >= (na + nb)
    return count_sorted_planes_multi(
        merged[:w], inv, tuple(x.astype(I32) for x in merged[w:]),
        cap_out=cap_out)


def sort_planes(planes, n_keys: int | None = None):
    """Sort flat limb planes ascending (sentinels to tail); planes beyond
    ``n_keys`` are payloads, carried stably."""
    planes = tuple(planes)
    if n_keys is None:
        n_keys = len(planes)
    return tuple(jax.lax.sort(planes, num_keys=n_keys))


def _encode_invalid(planes, valid, spare_bits: bool):
    """Sentinel-encode invalid rows for the sort: with spare bits the
    all-ones kmer is impossible, so invalid rows become all-ones keys;
    otherwise a leading validity plane is prepended (0 = valid).

    (Note: even without spare bits a CANONICAL kmer can never be
    all-ones — the all-ones value is G^k whose revcomp C^k is smaller —
    so table-level sentinels in merge paths are safe for every k; the
    extra validity key here only guards yet-uncanonicalized inputs.)"""
    if spare_bits:
        return tuple(jnp.where(valid, p, U32(0xFFFFFFFF)) for p in planes), 0
    vkey = jnp.where(valid, U32(0), U32(0xFFFFFFFF))
    return (vkey,) + planes, 1


def count_planes(planes, valid, weights=None, spare_bits: bool = False,
                 cap_out: int | None = None, blocked: bool = False):
    """Sort + reduce flat kmer planes into a distinct table (plane-major).

    planes: tuple of (N,) uint32; valid: (N,) bool;
    weights: optional per-row counts (table merge case). Returns
    (out_planes, counts, n, overflow).
    """
    enc, extra = _encode_invalid(planes, valid, spare_bits)
    n_keys = len(enc)
    payloads = () if weights is None else (weights.astype(U32),)
    out = sort_planes(enc + payloads, n_keys=n_keys)
    if extra:
        inv = out[0] != 0
        kplanes = out[1:n_keys]
    else:
        n_valid = jnp.sum(valid)
        idx = jax.lax.broadcasted_iota(I32, (enc[0].shape[0],), 0)
        inv = idx >= n_valid
        kplanes = out[:n_keys]
    w_ = out[n_keys].astype(I32) if weights is not None else None
    return count_sorted_planes(kplanes, inv, weights=w_, cap_out=cap_out,
                               blocked=blocked)


def count_planes_multibank(planes, valid, bank_ids, nb_banks: int,
                           spare_bits: bool = False,
                           cap_out: int | None = None):
    """One-pass multibank sort + reduce: kmers from all banks sort
    together with their bank id riding as a payload plane; the reduce
    yields per-bank count columns (reference per-bank kmer matrices,
    PartitionsCommand.cpp:1855-2100 — but in ONE pass over the union
    instead of per-bank passes)."""
    enc, extra = _encode_invalid(planes, valid, spare_bits)
    n_keys = len(enc)
    out = sort_planes(enc + (bank_ids.astype(U32),), n_keys=n_keys)
    if extra:
        inv = out[0] != 0
        kplanes = out[1:n_keys]
    else:
        n_valid = jnp.sum(valid)
        idx = jax.lax.broadcasted_iota(I32, (enc[0].shape[0],), 0)
        inv = idx >= n_valid
        kplanes = out[:n_keys]
    sbank = out[n_keys]
    weights = tuple((sbank == U32(b)).astype(I32) for b in range(nb_banks))
    return count_sorted_planes_multi(kplanes, inv, weights, cap_out=cap_out)


def pad_planes_pow2(planes, counts=None, min_cap: int = 256):
    """Pad host/device (n,) planes to the next power of two with sentinel
    rows (all-ones keys, zero counts). Returns (planes, counts, n)."""
    n = planes[0].shape[0]
    cap = _next_pow2(max(n, min_cap))
    pad = cap - n
    if pad:
        planes = tuple(jnp.concatenate(
            [p, jnp.full((pad,), U32(0xFFFFFFFF))]) for p in planes)
        if counts is not None:
            counts = jnp.concatenate([counts, jnp.zeros((pad,), I32)])
    return planes, counts, n


@functools.partial(jax.jit, static_argnames=("cap_out",))
def merge_tables_planes(pa, ca, na, pb, cb, nb, cap_out: int):
    """Merge two sorted distinct-key tables (plane-major) into one.

    pa/pb: tuples of (Ca,)/(Cb,) uint32 planes (power-of-two capacities,
    sentinel tails); ca/cb: (Ca,)/(Cb,) int32 counts; na/nb: live rows.
    One multi-key sort + the scatter-free reduce. Returns
    (planes, counts, n, overflow) at capacity cap_out.
    """
    ca_cap, cb_cap = pa[0].shape[0], pb[0].shape[0]
    if ca_cap != cb_cap:  # pad the smaller to the larger capacity
        cap = max(ca_cap, cb_cap)
        if ca_cap < cap:
            pa, ca, _ = pad_planes_pow2(pa, ca, min_cap=cap)
        else:
            pb, cb, _ = pad_planes_pow2(pb, cb, min_cap=cap)
    cap = pa[0].shape[0]
    planes = tuple(jnp.concatenate([x, y]) for x, y in zip(pa, pb))
    wts = jnp.concatenate([ca, cb]).astype(U32)
    # counts ride as an extra LSB key (summed per run downstream);
    # lax.sort here vs the elementwise merge network is not yet measured
    # on the H100
    merged = jax.lax.sort(planes + (wts,), num_keys=len(planes) + 1)
    idx = jax.lax.broadcasted_iota(I32, (2 * cap,), 0)
    inv = idx >= (na + nb)
    return count_sorted_planes(merged[:-1], inv,
                               weights=merged[-1].astype(I32),
                               cap_out=cap_out)


# ---------------------------------------------------------------------------
# Sort-join rank/membership (round 3): replaces binary-search probes.
#
# Every postsolid kernel (debloom's 8 probes/solid kmer, adjacency
# precompute, unitig candidate ranks, batched membership) needs
# rank-in-sorted-table for large query batches. A per-query binary search
# is log(n) RANDOM gathers; the merge-join below (chosen on an earlier
# accelerator where gathers were slow; not yet re-measured on the H100) uses
# only sorts + cumulative scans: co-sort (table + queries), read each
# query's rank off a running live-table-row count, and restore query
# order with one single-key sort.
# ---------------------------------------------------------------------------


def rank_join_traced(table: jnp.ndarray, queries: jnp.ndarray, n_table):
    """Rank + membership of query rows in a sorted distinct-key table.

    table: (C, W) uint32 ascending; rows >= n_table are all-ones padding.
    queries: (Q, W) uint32, any order; the all-ones row is never found
    (no canonical kmer is all-ones — see _encode_invalid note).
    Returns (rank (Q,) int32 — index in table, -1 if absent;
             found (Q,) bool), in the original query order.

    Sort-join formulation of the reference's per-kmer membership probes
    (DebloomAlgorithm.cpp:270-300, Graph.cpp:3508-3610): 2 sorts of
    (C + Q) rows, zero random gathers.
    """
    c, w = table.shape
    q = queries.shape[0]
    n = c + q
    idx_c = jax.lax.broadcasted_iota(I32, (c,), 0)
    # tag orders equal keys as: live table row (0) < query (1) < padding
    # (2) — so a live table row is always the first row of its equal-key
    # run, and a query matching only padding rows is never "found".
    tag = jnp.concatenate([jnp.where(idx_c < n_table, U32(0), U32(2)),
                           jnp.full((q,), U32(1))])
    orig = jnp.concatenate([jnp.full((c,), U32(0xFFFFFFFF)),
                            jax.lax.broadcasted_iota(U32, (q,), 0)])
    planes = tuple(jnp.concatenate([table[:, j], queries[:, j]])
                   for j in range(w))
    out = jax.lax.sort(planes + (tag, orig), num_keys=w + 1)
    kp, stag, sorig = out[:w], out[w], out[w + 1]
    is_table = stag == 0
    ct = jnp.cumsum(is_table.astype(I32))     # live table rows seen so far
    neq = kp[0][1:] != kp[0][:-1]
    for p in kp[1:]:
        neq = neq | (p[1:] != p[:-1])
    starts = jnp.concatenate([jnp.ones((1,), bool), neq])
    pos = jax.lax.broadcasted_iota(I32, (n,), 0)
    run_start = jax.lax.cummax(jnp.where(starts, pos, -1))
    last_tab = jax.lax.cummax(jnp.where(is_table, pos, -1))
    # found <=> my equal-key run begins with a live table row (which is
    # then the nearest preceding one, at table index ct - 1)
    found = last_tab >= run_start
    rank = jnp.where(found, ct - 1, -1)
    # restore original query order: single-key compaction sort
    key2 = jnp.where(stag == U32(1), sorig, U32(0xFFFFFFFF))
    out2 = jax.lax.sort((key2, rank.astype(U32), found.astype(U32)),
                        num_keys=1)
    return out2[1][:q].astype(I32), out2[2][:q] != 0


# public jitted entry (n_table static); rank_join_traced is the raw body
# for callers already inside a trace with a TRACED n_table (the
# mesh-sharded postsolid kernels, parallel/postsolid.py)
rank_join = functools.partial(jax.jit, static_argnames=("n_table",))(
    rank_join_traced)


def pad_rows_pow2(table: "np.ndarray"):
    """Host helper: pad a sorted (N, W) uint32 row table to the next
    power-of-two capacity with all-ones sentinel rows. With a TRACED
    n_table (rank_join_traced), every capacity bucket compiles ONCE no
    matter how N drifts between calls — shape discipline for the
    postsolid sweeps (each new shape is a fresh compile)."""
    import numpy as np

    n, w = table.shape if table.ndim == 2 else (0, 1)
    cap = 1
    while cap < max(n, 1):
        cap <<= 1
    if cap == n:
        return table, n
    out = np.full((cap, w), 0xFFFFFFFF, np.uint32)
    out[:n] = table
    return out, n


def sweep_chunk(n: int, parts: int = 1, lo: int = 4096,
                hi: int = 1 << 21) -> int:
    """Query-chunk size for table sweeps: ~``parts`` chunks per sweep
    (each chunk's sort-join re-sorts the whole table AND pays a
    dispatch, so fewer, larger chunks win — the default
    is ONE chunk whenever the table fits under ``hi`` rows; giant
    tables still split so the 8x-candidate join bounds HBM), clamped
    and rounded to a power of two so chunk shapes stay stable across
    compaction passes."""
    t = max(lo, min(hi, -(-max(n, 1) // parts)))
    p = 1
    while p < t:
        p <<= 1
    return p


def rank_limbs(table: jnp.ndarray, queries: jnp.ndarray, n_table: int,
               method: str = "auto"):
    """Dispatch rank/membership to sort-join or binary search.

    Binary search (log n random gathers per query) wins for small query
    batches against a big table; the sort-join wins whenever Q is within
    a few orders of magnitude of C (all the postsolid bulk kernels).
    The switch point was tuned on an earlier accelerator and is not yet
    measured on the H100. Same return contract as rank_join.
    """
    q = queries.shape[0]
    if method == "auto":
        method = "join" if q >= 4096 and q * 64 >= n_table else "binsearch"
    if method == "join":
        return rank_join(table, queries, n_table)
    from ..collections.sortedset import _searchsorted_limbs

    pos = _searchsorted_limbs(table, queries, n_table)
    safe = jnp.minimum(pos, max(n_table - 1, 0))
    found = jnp.all(table[safe] == queries, axis=-1) & (pos < n_table)
    if n_table == 0:
        found = jnp.zeros((q,), bool)
    return jnp.where(found, pos, -1), found


def shrink(table: CountTable, capacity: int) -> CountTable:
    """Host-side: shrink/grow a table to the given capacity (>= n)."""
    import numpy as np

    n = int(table.n)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < live rows {n}")
    w = table.width
    kmers = np.full((capacity, w), 0xFFFFFFFF, dtype=np.uint32)
    counts = np.zeros((capacity,), dtype=np.int32)
    kmers[:n] = np.asarray(table.kmers)[:n]
    counts[:n] = np.asarray(table.counts)[:n]
    return CountTable(jnp.asarray(kmers), jnp.asarray(counts), jnp.asarray(n, I32))
