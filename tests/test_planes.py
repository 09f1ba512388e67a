"""Plane-major counting pipeline: scatter-free reduce + table merges.

These are the round-2 production kernels (ops/sortops.py plane-major
section); exactness is pinned against numpy dict counting.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gatb_core_tpu.ops.sortops import (
    count_planes, count_sorted_planes, merge_tables_planes, pad_planes_pow2,
)


def np_count(vals_valid):
    from collections import Counter

    c = Counter(vals_valid.tolist())
    keys = np.array(sorted(c), dtype=np.uint64)
    cnts = np.array([c[k] for k in sorted(c)], dtype=np.int32)
    return keys, cnts


def to_planes(v64):
    return (jnp.asarray((v64 >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((v64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def from_planes(planes, n):
    hi = np.asarray(planes[0])[:n].astype(np.uint64)
    lo = np.asarray(planes[1])[:n].astype(np.uint64)
    return (hi << np.uint64(32)) | lo


@pytest.mark.parametrize("spare", [True, False])
def test_count_planes_matches_dict(spare):
    rng = np.random.default_rng(42)
    n = 4096
    # duplicates guaranteed: small key space
    vals = rng.integers(0, 500, n).astype(np.uint64) * np.uint64(0x100000001)
    valid = rng.random(n) > 0.2
    planes = to_planes(vals)
    out_p, counts, nd, overflow = count_planes(
        planes, jnp.asarray(valid), spare_bits=spare)
    nd = int(nd)
    assert not bool(overflow)
    keys, cnts = np_count(vals[valid])
    assert nd == len(keys)
    got = from_planes(out_p, nd)
    assert (got == keys).all()
    assert (np.asarray(counts)[:nd] == cnts).all()
    assert (np.asarray(counts)[nd:] == 0).all()


@pytest.mark.parametrize("w", [1, 2, 4])
@pytest.mark.parametrize("run", [1, 4, 64, 512])
@pytest.mark.parametrize("sentinels", [0.0, 0.3])
def test_merge_sorted_runs(w, run, sentinels):
    """The fold's bitonic merge level turns pairs of ascending runs into
    ascending runs of twice the length, all-ones sentinel rows last."""
    from gatb_core_tpu.ops.sortops import _merge_sorted_runs

    rng = np.random.default_rng(run * 10 + w)
    n = 4 * run if run >= 128 else 1024
    rows = rng.integers(0, 50, (n, w)).astype(np.uint32)
    rows[rng.random(n) < sentinels] = 0xFFFFFFFF
    runs = []
    for i in range(0, n, run):      # ascending runs of length `run`
        blk = rows[i:i + run]
        runs.append(blk[np.lexsort(blk.T[::-1])])
    rows = np.concatenate(runs)
    out = _merge_sorted_runs(tuple(jnp.asarray(rows[:, j])
                                   for j in range(w)), run)
    got = np.stack([np.asarray(x) for x in out], axis=1)
    for i in range(0, n, 2 * run):
        blk = rows[i:i + 2 * run]
        np.testing.assert_array_equal(got[i:i + 2 * run],
                                      blk[np.lexsort(blk.T[::-1])])


def test_count_sorted_planes_cap_and_overflow():
    vals = np.array([1, 1, 2, 3, 3, 3, 4, 5], np.uint64)
    planes = to_planes(vals)
    inv = jnp.zeros(8, bool)
    _, counts, n, ov = count_sorted_planes(planes, inv, cap_out=8)
    assert int(n) == 5 and not bool(ov)
    assert np.asarray(counts)[:5].tolist() == [2, 1, 3, 1, 1]
    # overflow flagged when cap_out < n
    _, _, n2, ov2 = count_sorted_planes(planes, inv, cap_out=4)
    assert int(n2) == 5 and bool(ov2)


def test_count_sorted_planes_all_invalid():
    planes = (jnp.full((256,), 0xFFFFFFFF, jnp.uint32),
              jnp.full((256,), 0xFFFFFFFF, jnp.uint32))
    inv = jnp.ones(256, bool)
    out_p, counts, n, ov = count_sorted_planes(planes, inv)
    assert int(n) == 0 and not bool(ov)
    assert (np.asarray(counts) == 0).all()


def test_merge_tables_planes():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 200, 700).astype(np.uint64)
    b = rng.integers(100, 400, 300).astype(np.uint64)
    ka, ca = np_count(a)
    kb, cb = np_count(b)
    pa, ca_j, na = pad_planes_pow2(to_planes(ka), jnp.asarray(ca))
    pb, cb_j, nb = pad_planes_pow2(to_planes(kb), jnp.asarray(cb))
    out_p, counts, n, ov = merge_tables_planes(
        pa, ca_j, na, pb, cb_j, nb, cap_out=2048)
    keys, cnts = np_count(np.concatenate([a, b]))
    n = int(n)
    assert not bool(ov)
    assert n == len(keys)
    assert (from_planes(out_p, n) == keys).all()
    assert (np.asarray(counts)[:n] == cnts).all()


def test_merge_tables_planes_different_caps():
    a = np.arange(100, dtype=np.uint64)
    b = np.arange(50, 80, dtype=np.uint64)
    ka, ca = np_count(a)
    kb, cb = np_count(b)
    pa, ca_j, na = pad_planes_pow2(to_planes(ka), jnp.asarray(ca))
    pb, cb_j, nb = pad_planes_pow2(to_planes(kb), jnp.asarray(cb),
                                   min_cap=32)
    out_p, counts, n, _ = merge_tables_planes(
        pa, ca_j, na, pb, cb_j, nb, cap_out=256)
    keys, cnts = np_count(np.concatenate([a, b]))
    assert int(n) == len(keys)
    assert (from_planes(out_p, int(n)) == keys).all()
    assert (np.asarray(counts)[:int(n)] == cnts).all()

@pytest.mark.parametrize("spare", [True, False])
def test_count_planes_blocked_matches_single(spare):
    """Blocked two-level compaction == single-sort compaction (round 3)."""
    rng = np.random.default_rng(11)
    n = 1 << 14
    vals = rng.integers(0, 1500, n).astype(np.uint64) * np.uint64(0x100000001)
    valid = rng.random(n) > 0.15
    planes = to_planes(vals)
    ref = count_planes(planes, jnp.asarray(valid), spare_bits=spare,
                       cap_out=2048)
    got = count_planes(planes, jnp.asarray(valid), spare_bits=spare,
                       cap_out=2048, blocked=True)
    assert not bool(got[3]) and not bool(ref[3])
    assert int(got[2]) == int(ref[2])
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))


def test_count_planes_blocked_overflow_flag():
    """All-distinct data with a tight cap trips the blocked overflow (the
    per-block slice loses rows) instead of returning wrong counts."""
    n = 1 << 13
    vals = np.arange(n, dtype=np.uint64)
    planes = to_planes(vals)
    inv = jnp.zeros(n, bool)
    out_p, counts, nd, ov = count_sorted_planes(planes, inv, cap_out=256,
                                                blocked=True)
    assert bool(ov)
    # safe retry at full capacity succeeds
    out_p, counts, nd, ov = count_sorted_planes(planes, inv, cap_out=n,
                                                blocked=True)
    assert not bool(ov) and int(nd) == n
    np.testing.assert_array_equal(np.asarray(counts), np.ones(n, np.int32))


def test_count_planes_blocked_weights():
    rng = np.random.default_rng(5)
    n = 1 << 13
    vals = np.sort(rng.integers(0, 900, n).astype(np.uint64))
    planes = to_planes(vals)
    inv = jnp.zeros(n, bool)
    w = jnp.asarray(rng.integers(1, 5, n).astype(np.int32))
    ref = count_sorted_planes(planes, inv, weights=w, cap_out=1024)
    got = count_sorted_planes(planes, inv, weights=w, cap_out=1024,
                              blocked=True)
    assert int(got[2]) == int(ref[2]) and not bool(got[3])
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(ref[1]))
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
