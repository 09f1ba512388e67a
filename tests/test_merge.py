"""Capacity-bounded device merge tree (ops/sortops.merge_stacked_tree_capped)
vs the uncapped tree and a dict ground truth."""

import numpy as np
import jax.numpy as jnp
import pytest

from gatb_core_tpu.ops.sortops import (
    CountTable, count_batch, merge_stacked_tree, merge_stacked_tree_capped)


def _rand_tables(rng, nb, rows, w, key_space, cap):
    """nb sorted distinct-key tables (capacity cap) + the global dict."""
    ks, cs, truth = [], [], {}
    for _ in range(nb):
        raw = rng.integers(0, key_space, size=(rows,), dtype=np.uint64)
        uniq, cnt = np.unique(raw, return_counts=True)
        k = np.full((cap, w), 0xFFFFFFFF, np.uint32)
        c = np.zeros((cap,), np.int32)
        for j in range(w):
            shift = 32 * (w - 1 - j)
            k[: len(uniq), j] = (uniq >> shift).astype(np.uint32)
        c[: len(uniq)] = cnt
        ks.append(k)
        cs.append(c)
        for u, n in zip(uniq.tolist(), cnt.tolist()):
            truth[u] = truth.get(u, 0) + n
    return np.stack(ks), np.stack(cs), truth


def _table_dict(t: CountTable, w):
    n = int(t.n)
    k = np.asarray(t.kmers)[:n].astype(np.uint64)
    vals = np.zeros((n,), np.uint64)
    for j in range(w):
        vals = (vals << np.uint64(32)) | k[:, j]
    return dict(zip(vals.tolist(), np.asarray(t.counts)[:n].tolist()))


@pytest.mark.parametrize("nb,w", [(1, 1), (2, 1), (5, 2), (8, 2), (13, 1)])
def test_capped_matches_uncapped_and_truth(nb, w):
    rng = np.random.default_rng(nb * 10 + w)
    rows, cap = 300, 512
    key_space = 700 if w == 1 else (1 << 40)
    ks, cs, truth = _rand_tables(rng, nb, rows, w, key_space, cap)
    capped, ov = merge_stacked_tree_capped(jnp.asarray(ks), jnp.asarray(cs),
                                           cap=8192)
    assert not bool(ov)
    assert _table_dict(capped, w) == truth
    ref = merge_stacked_tree(jnp.asarray(ks), jnp.asarray(cs))
    assert _table_dict(ref, w) == truth
    # sorted ascending
    n = int(capped.n)
    kk = np.asarray(capped.kmers)[:n].astype(np.uint64)
    v = np.zeros((n,), np.uint64)
    for j in range(w):
        v = (v << np.uint64(32)) | kk[:, j]
    assert np.all(np.diff(v.astype(np.int64)) > 0)


def test_overflow_flag():
    rng = np.random.default_rng(0)
    ks, cs, truth = _rand_tables(rng, 4, 300, 1, 1 << 30, 512)
    # nearly all keys distinct: ~1200 live rows > cap 256
    _, ov = merge_stacked_tree_capped(jnp.asarray(ks), jnp.asarray(cs),
                                      cap=256)
    assert bool(ov)


def test_from_count_batch():
    """End-to-end: per-batch count tables through the capped tree equal the
    naive dict count."""
    rng = np.random.default_rng(3)
    nb, rows, w = 6, 256, 2
    batches = rng.integers(0, 1 << 35, size=(nb, rows), dtype=np.uint64)
    valid = rng.random((nb, rows)) < 0.9
    ks, cs, truth = [], [], {}
    cap = None
    for i in range(nb):
        km = np.stack([(batches[i] >> np.uint64(32)).astype(np.uint32),
                       batches[i].astype(np.uint32)], axis=-1)
        t = count_batch(jnp.asarray(km), jnp.asarray(valid[i]),
                        spare_bits=True)
        ks.append(np.asarray(t.kmers))
        cs.append(np.asarray(t.counts))
        cap = t.capacity
        for u, ok in zip(batches[i].tolist(), valid[i].tolist()):
            if ok:
                truth[u] = truth.get(u, 0) + 1
    merged, ov = merge_stacked_tree_capped(
        jnp.asarray(np.stack(ks)), jnp.asarray(np.stack(cs)), cap=4096)
    assert not bool(ov)
    assert _table_dict(merged, w) == truth


def test_merge_ub_sync_bounds_caps(monkeypatch):
    """Chained high-overlap merges must not let the ub bound (and so the
    next merge capacity) grow toward the total-row sum: past the sync
    threshold the exact n is fetched and becomes the bound (the r4
    stress OOM regression)."""
    import jax.numpy as jnp
    import numpy as np

    from gatb_core_tpu.kmer import counting as C

    monkeypatch.setattr(C, "_SYNC_UB_ROWS", 64)
    w = 2
    rng = np.random.default_rng(0)
    base = np.unique(rng.integers(0, 2**31, size=(50, w)).astype(np.uint32),
                     axis=0)
    order = np.lexsort((base[:, 1], base[:, 0]))
    base = base[order]

    def table(rows):
        cap = 64
        pk = [np.full(cap, 0xFFFFFFFF, np.uint32) for _ in range(w)]
        pc = np.zeros(cap, np.int32)
        for j in range(w):
            pk[j][:len(rows)] = rows[:, j]
        pc[:len(rows)] = 1
        return (tuple(jnp.asarray(p) for p in pk), jnp.asarray(pc),
                len(rows), len(rows))

    # three highly-overlapping tables: each merge's union stays ~50 rows
    lst = [table(base), table(base), table(base[:40])]
    C._merge_smallest_pair(lst)
    C._merge_smallest_pair(lst)
    planes, counts, n, ub = lst[0]
    assert int(np.asarray(n)) == len(base)
    total = int(np.asarray(counts).sum())
    assert total == 140  # 50 + 50 + 40 occurrences survive the reduce
    # the bound is refreshed LAZILY: the next merge's prologue collapses
    # any bound past the sync threshold to the exact n BEFORE sizing
    # capacities (r4: the eager output-time sync serialized the chain)
    assert ub >= len(base)          # soft bound may be inflated here
    lst.append(table(base[:10]))
    C._merge_smallest_pair(lst)
    _, counts2, n2, ub2 = lst[0]
    assert int(np.asarray(n2)) == len(base)
    assert ub2 == len(base) + 10    # exact(50) + fresh(10), not 140+10
