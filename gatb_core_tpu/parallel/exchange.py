"""Multi-chip counting step: minimizer-partition all-to-all over the mesh.

This is the device equivalent of DSK's minimizer->partition spill
(SortingCountAlgorithm::fillPartitions, kmer/impl/SortingCountAlgorithm.cpp:
1211-1345): instead of superkmer files + per-file mutexes, each device
extracts the kmers of its read shard, assigns each kmer a partition from its
minimizer, and the partitions are exchanged via `jax.lax.all_to_all` over the
mesh so that device p receives every kmer whose partition is p. Each
device then sorts + segment-reduces its partitions locally (the counting
kernel, replacing PartitionsCommand's radix sort + 453-way merge).

The final count table is partition-invariant: concatenating the per-device
tables and sorting yields exactly the single-chip (and reference) table.

Static-shape note: all_to_all requires equal-size sends. Send buffers are
fixed-capacity per (src, dst) pair; rare overflow (power-law minimizer skew)
is *not* silently dropped — overflowed kmers are retained locally in an
"overflow" table that is merged on host, preserving exactness.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops.kmer_ops import extract_kmers
from ..ops.sortops import CountTable, count_sorted, sort_by_kmer
from .mesh import DATA_AXIS

U32 = jnp.uint32
I32 = jnp.int32


def partition_of_minimizer(minim: jnp.ndarray, n_parts: int,
                           repart_table: jnp.ndarray | None = None
                           ) -> jnp.ndarray:
    """Minimizer -> partition id.

    With a Repartitor table (kmer/repartition.py — the reference's greedy
    load-balanced assignment, PartiInfo.cpp:48-106) this is a gather;
    otherwise a multiplicative hash spreads the skewed (banned-AA)
    minimizer distribution adequately. Partitioning only affects balance,
    never results.
    """
    if repart_table is not None:
        return repart_table[minim.astype(jnp.int32)].astype(I32)
    h = (minim.astype(U32) * U32(0x9E3779B1)) >> 16
    return (h % U32(n_parts)).astype(I32)


class ShardCount(NamedTuple):
    """Stacked per-device output of the exchange+count step.

    table.kmers has global shape (ndev*cap_t, W) with the device axis
    sharded; table.n / overflow.n are (ndev,) per-device live-row counts.
    """

    table: CountTable          # counts of kmers routed to each device
    overflow: CountTable       # counts of kmers that missed the send window
    n_overflowed: jnp.ndarray  # (ndev,) overflow sizes (retained, not lost)


def _local_count(kmers: jnp.ndarray, invalid: jnp.ndarray) -> CountTable:
    sk, si = sort_by_kmer(kmers, invalid)
    return count_sorted(sk, si)


def make_count_step(mesh, k: int, m: int = 10, capacity_factor: float = 2.0,
                    repartitor=None, nb_passes: int = 1):
    """Build the jitted multi-chip counting step over ``mesh``.

    Returns fn(codes, valid, lengths, pass_i) where arrays are global with
    leading batch dim sharded over the data axis; output is a ShardCount
    whose arrays keep the device dimension sharded. ``repartitor``
    (optional, kmer/repartition.Repartitor) supplies the load-balanced
    minimizer -> partition table, replicated to every device. With
    nb_passes > 1 the DSK pass filter applies (minimizer % nb_passes ==
    pass_i, SortingCountAlgorithm.cpp:806).
    """
    ndev = mesh.shape[DATA_AXIS]
    repart_table = None
    if repartitor is not None:
        import numpy as _np

        if repartitor.nb_partitions != ndev:
            raise ValueError("repartitor partitions != mesh size")
        repart_table = jnp.asarray(
            _np.asarray(repartitor.table, _np.int32))

    def step(codes, valid, lengths, pass_i):
        # codes: (b, L) local shard
        kb = extract_kmers(codes, valid, lengths, k, m)
        w = kb.kmers.shape[-1]
        flat_k = kb.kmers.reshape(-1, w)
        flat_v = kb.valid.reshape(-1)
        if nb_passes > 1:
            flat_v = flat_v & (kb.minimizer.reshape(-1)
                               % jnp.uint32(nb_passes)
                               == pass_i.astype(jnp.uint32))
        n = flat_k.shape[0]
        cap = int(capacity_factor * n / ndev) if ndev > 1 else n
        cap = max(cap, 1)

        pid = partition_of_minimizer(kb.minimizer.reshape(-1), ndev,
                                     repart_table)
        # invalid kmers: route nowhere (pid ndev -> dropped from sends)
        pid = jnp.where(flat_v, pid, ndev)

        # sort locally by pid so each partition is contiguous
        order = jnp.argsort(pid, stable=True)
        pid_s = pid[order]
        kmer_s = flat_k[order]

        # rank within partition
        pos = jax.lax.broadcasted_iota(I32, (n,), 0)
        starts = jnp.searchsorted(pid_s, jnp.arange(ndev + 1, dtype=I32))
        rank = pos - starts[jnp.clip(pid_s, 0, ndev)]

        # scatter into (ndev, cap) send buffer; overflow/invalid -> dropped
        in_window = (rank < cap) & (pid_s < ndev)
        dest = jnp.where(in_window, pid_s * cap + rank, ndev * cap)
        send_k = jnp.full((ndev * cap, w), U32(0xFFFFFFFF))
        send_k = send_k.at[dest].set(kmer_s, mode="drop")
        send_live = jnp.zeros((ndev * cap,), bool)
        send_live = send_live.at[dest].set(in_window, mode="drop")

        # exchange: device p receives row [s] = what s sent to p
        recv_k = jax.lax.all_to_all(
            send_k.reshape(ndev, cap, w), DATA_AXIS, 0, 0)
        recv_live = jax.lax.all_to_all(
            send_live.reshape(ndev, cap), DATA_AXIS, 0, 0)

        table = _local_count(recv_k.reshape(-1, w), ~recv_live.reshape(-1))

        # overflowed kmers (valid but rank >= cap): count locally, exact
        over = flat_v[order] & (rank >= cap) & (pid_s < ndev)
        otable = _local_count(kmer_s, ~over)
        n_over = jnp.sum(over).astype(I32)
        # flat tuple; scalars lifted to (1,) so the device axis can shard them
        return (table.kmers, table.counts, table.n.reshape(1),
                otable.kmers, otable.counts, otable.n.reshape(1),
                n_over.reshape(1))

    spec_in = P(DATA_AXIS)
    spec_out = tuple([P(DATA_AXIS)] * 7)
    fn = shard_map(step, mesh=mesh,
                   in_specs=(spec_in, spec_in, spec_in, P()),
                   out_specs=spec_out)
    jfn = jax.jit(fn)

    def wrapped(codes, valid, lengths, pass_i=None) -> ShardCount:
        if pass_i is None:
            pass_i = jnp.int32(0)
        tk, tc, tn, ok, oc, on, nover = jfn(codes, valid, lengths, pass_i)
        return ShardCount(CountTable(tk, tc, tn), CountTable(ok, oc, on),
                          nover)

    return wrapped


def count_kmers_distributed(bank, mesh, **kwargs):
    """End-to-end multi-device SortingCount over a mesh — production shape.

    Delegates to the superbatch exchange driver
    (parallel/superbatch.py): one dispatch per superbatch covering
    extraction + range-partition all-to-all + device-resident accumulator
    merge, one table fetch per pass, transactional overflow retry. The
    batch-granular host-merge driver below remains available as
    count_kmers_distributed_hostmerge (correctness harness / reference
    for the equality tests).
    """
    from .superbatch import count_kmers_distributed_superbatch

    return count_kmers_distributed_superbatch(bank, mesh, **kwargs)


def count_kmers_distributed_hostmerge(
        bank, mesh, kmer_size: int = 31,
        minimizer_size: int = 10, abundance_min=2,
        abundance_max: int = 2**31 - 1,
        nb_passes: int = 1,
        batch_reads_per_device: int = 256,
        batch_len: int = 256,
        capacity_factor: float = 2.0,
        repartitor="auto",
        histo_max: int = 10000):
    """Batch-granular multi-device SortingCount (host merge per batch).

    The full production pipeline of SortingCountAlgorithm::execute
    (kmer/impl/SortingCountAlgorithm.cpp:636-680) in SPMD form: the bank
    streams as fixed global batches sharded over the data axis, each batch
    runs extraction -> repartitor-table all-to-all (fillPartitions,
    :1211-1345) -> per-device sort/segment-reduce, with the DSK pass loop
    on top; per-device partial tables (+ retained overflow rows) merge into
    the final globally-sorted table, which is bitwise equal to the
    single-device (and reference) result for any mesh size.

    repartitor: 'auto' builds the sampled-census greedy table
    (RepartitorAlgorithm equivalent); None uses the multiplicative hash;
    or pass a kmer.repartition.Repartitor.
    """
    import numpy as np

    from ..bank.fasta import open_bank
    from ..kmer.counting import (_BatchBuilder, _global_merge, _prefetch,
                                 CountConfig, CountResult)
    from ..kmer.histogram import Histogram
    from ..ops.kmer_ops import nb_limbs

    bank = open_bank(bank)
    k = kmer_size
    ndev = mesh.shape[DATA_AXIS]
    if repartitor == "auto":
        from ..kmer.repartition import build_repartitor

        repartitor = build_repartitor(bank, k, ndev, minimizer_size)
    step = make_count_step(mesh, k, minimizer_size,
                           capacity_factor=capacity_factor,
                           repartitor=repartitor, nb_passes=nb_passes)

    B = batch_reads_per_device * ndev
    builder = _BatchBuilder(k, B, batch_len)

    def produce():
        for seq in bank:
            yield from builder.add(seq.data)
        if builder.row:
            yield builder.flush()

    parts_k: list = []
    parts_c: list = []
    nb_seq = 0
    seq_total = 0
    for pass_i in range(max(1, nb_passes)):
        for codes, valid, lengths, rows in _prefetch(produce(), depth=2):
            if pass_i == 0:
                nb_seq += rows
                seq_total += int(lengths.sum())
            shards = step(jnp.asarray(codes), jnp.asarray(valid),
                          jnp.asarray(lengths), jnp.int32(pass_i))
            bk, bc = global_table(shards, ndev)
            if len(bk):
                parts_k.append(bk)
                parts_c.append(bc)

    w = nb_limbs(k)
    if parts_k:
        uniq, counts = _global_merge(np.concatenate(parts_k),
                                     np.concatenate(parts_c), w)
    else:
        uniq = np.zeros((0, w), np.uint32)
        counts = np.zeros((0,), np.int32)

    histogram = Histogram(histo_max)
    if len(counts):
        histogram.add_counts(counts)
    if abundance_min == "auto":
        amin = histogram.compute_threshold(2)
    else:
        amin = int(abundance_min)
        histogram.cutoff = amin
    solid = (counts >= amin) & (counts <= abundance_max)
    info = {
        "kmers_nb_distinct": int(len(counts)),
        "kmers_nb_solid": int(solid.sum()),
        "kmers_nb_weak": int(len(counts) - solid.sum()),
        "kmers_nb_valid": int(counts.sum()),
        "sequences_number": int(nb_seq),
        "sequences_size": int(seq_total),
        "kmer_size": k,
        "abundance_min": amin,
        "abundance_max": abundance_max,
        "nb_devices": ndev,
        "nb_passes": max(1, nb_passes),
    }
    cfg = CountConfig(kmer_size=k, minimizer_size=minimizer_size,
                      abundance_min=abundance_min,
                      abundance_max=abundance_max, nb_passes=nb_passes)
    histogram.nb_solids_after_cutoff = int(solid.sum())
    return CountResult(uniq[solid], counts[solid], histogram, info, cfg)


def global_table(shards: ShardCount, ndev: int):
    """Host-side: merge the per-device tables (+ overflow) into the final
    globally sorted (kmers, counts) numpy arrays. Exact: per-device tables
    are disjoint by partition; overflow rows merge by summation."""
    import numpy as np

    tk = np.asarray(shards.table.kmers)
    tc = np.asarray(shards.table.counts)
    tn = np.asarray(shards.table.n).reshape(ndev)
    ok = np.asarray(shards.overflow.kmers)
    oc = np.asarray(shards.overflow.counts)
    on = np.asarray(shards.overflow.n).reshape(ndev)
    cap_t = tk.shape[0] // ndev
    cap_o = ok.shape[0] // ndev
    parts_k, parts_c = [], []
    for d in range(ndev):
        parts_k.append(tk[d * cap_t: d * cap_t + tn[d]])
        parts_c.append(tc[d * cap_t: d * cap_t + tn[d]])
        parts_k.append(ok[d * cap_o: d * cap_o + on[d]])
        parts_c.append(oc[d * cap_o: d * cap_o + on[d]])
    all_k = np.concatenate(parts_k, axis=0)
    all_c = np.concatenate(parts_c, axis=0)
    from ..kmer.counting import _global_merge

    return _global_merge(all_k, all_c, tk.shape[-1])
