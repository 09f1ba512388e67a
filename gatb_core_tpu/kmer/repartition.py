"""Minimizer -> partition repartition table (load balancing).

Port of gatb-core RepartitorAlgorithm / Repartitor (kmer/impl/
RepartitionAlgorithm.cpp, PartiInfo.cpp:48-106): a sample of the input is
scanned, kmers per minimizer are censused, and minimizer bins are packed
into partitions greedily — largest bin into the emptiest partition (a
priority queue in the reference; a heap here, same assignment order).

On a device mesh, the table balances the all-to-all minimizer exchange
(parallel/exchange.py) the same way it balances the reference's
superkmer partition files (SURVEY §2.11: minimizer skew is power-law;
greedy packing is the answer to 10x stragglers).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp


@dataclass
class Repartitor:
    """Minimizer -> partition lookup table (PartiInfo.hpp:323)."""

    table: np.ndarray        # (4^m,) uint16 partition ids
    nb_partitions: int
    minimizer_size: int

    MAGIC = 0x12345678  # save/load magic (PartiInfo.cpp:228-293)

    def __call__(self, minimizers) -> np.ndarray:
        return self.table[np.asarray(minimizers)]

    def device_table(self) -> jnp.ndarray:
        return jnp.asarray(self.table.astype(np.int32))

    # -- persistence (Repartitor::save/load, PartiInfo.cpp:228-293):
    #    byte-exact reference stream format, so /minimizers in our .h5
    #    matches what the reference binary reads/writes:
    #    <u16 nbpart> <u64 nb_minims> <u16 nbPass> <u16 table[nb_minims]>
    #    <u8 hasFreq> <u32 magic 0x12345678> (+ minimFrequency stream)
    def save(self, storage, freq_order=None, nb_pass: int = 1) -> None:
        import struct

        g = storage.group("minimizers")
        nb_minims = len(self.table)
        out = bytearray()
        out += struct.pack("<HQH", self.nb_partitions, nb_minims, nb_pass)
        out += self.table.astype("<u2").tobytes()
        out += struct.pack("<BI", 1 if freq_order is not None else 0,
                           self.MAGIC)
        with g.ostream("minimRepart") as os_:
            os_.write(bytes(out))
        if freq_order is not None:
            with g.ostream("minimFrequency") as os2:
                os2.write(np.asarray(freq_order, "<u4").tobytes())
                os2.write(struct.pack("<I", self.MAGIC))
        g.set_property("minimizer_size", np.uint64(self.minimizer_size))

    @classmethod
    def load(cls, storage) -> "Repartitor":
        import struct

        g = storage.group("minimizers")
        raw = g.get_dataset("minimRepart")
        if raw is None:
            raise ValueError("no minimRepart stream")
        raw = np.asarray(raw)
        if raw.dtype == np.uint16:  # legacy round-1 dataset layout
            table = raw
            nbpart = int(table.max()) + 1
        else:
            buf = raw.astype(np.uint8).tobytes()
            nbpart, nb_minims, _nb_pass = struct.unpack_from("<HQH", buf, 0)
            (magic,) = struct.unpack_from("<I", buf, len(buf) - 4)
            if magic != cls.MAGIC:
                raise ValueError("bad repartition magic")
            table = np.frombuffer(buf, "<u2", count=nb_minims, offset=12)
        m = max(1, int(round(np.log2(max(len(table), 4)) / 2)))
        msize = int(g.get_property("minimizer_size", m))
        return cls(np.array(table), nbpart, msize)


def compute_distrib(bin_sizes: np.ndarray, nb_partitions: int) -> np.ndarray:
    """Greedy largest-bin-into-emptiest-partition packing, exact port of
    Repartitor::computeDistrib (PartiInfo.cpp:48-106).

    bin_sizes: (4^m,) kxmer counts per minimizer.
    Returns (4^m,) partition assignment.
    """
    nb_minims = len(bin_sizes)
    table = np.zeros(nb_minims, np.uint16)
    # heap of (space_used, partition) — emptiest first, ties by id like
    # the reference's compSpaceTriple
    heap = [(0, jj) for jj in range(nb_partitions)]
    heapq.heapify(heap)
    # sort minimizer bins by size descending (stable on minimizer id,
    # matching std::sort with comp_bins on (size, id) pairs)
    order = np.lexsort((np.arange(nb_minims), -bin_sizes.astype(np.int64)))
    for mm in order:
        used, jj = heapq.heappop(heap)
        table[mm] = jj
        heapq.heappush(heap, (used + int(bin_sizes[mm]), jj))
    return table


def census_minimizers(bank, kmer_size: int, minimizer_size: int = 10,
                      max_sample_seqs: int = 50_000,
                      batch_reads: int = 1024,
                      batch_len: int = 256) -> np.ndarray:
    """Sample the bank and census kmers per minimizer
    (RepartitorAlgorithm sampling, RepartitionAlgorithm.cpp:311-384:
    min(5%, 50M) sample; bounded here by max_sample_seqs)."""
    from ..bank.fasta import open_bank
    from ..ops.kmer_ops import extract_kmers
    from .counting import _BatchBuilder

    bank = open_bank(bank)
    nb_minims = 1 << (2 * minimizer_size)
    counts = np.zeros(nb_minims, np.int64)
    builder = _BatchBuilder(kmer_size, batch_reads, batch_len)
    n_seqs = 0

    def process(codes, valid, lengths, rows):
        kb = extract_kmers(jnp.asarray(codes), jnp.asarray(valid),
                           jnp.asarray(lengths), kmer_size, minimizer_size)
        minim = np.asarray(kb.minimizer)[np.asarray(kb.valid)]
        counts[:] += np.bincount(minim, minlength=nb_minims)[:nb_minims]

    for seq in bank:
        n_seqs += 1
        if n_seqs > max_sample_seqs:
            break
        for batch in builder.add(seq.data):
            process(*batch)
    if builder.row:
        process(*builder.flush())
    return counts


def build_repartitor(bank, kmer_size: int, nb_partitions: int,
                     minimizer_size: int = 10, **kwargs) -> Repartitor:
    """RepartitorAlgorithm.execute equivalent: census + greedy packing."""
    sizes = census_minimizers(bank, kmer_size, minimizer_size, **kwargs)
    table = compute_distrib(sizes, nb_partitions)
    return Repartitor(table, nb_partitions, minimizer_size)


# ---------------------------------------------------------------------------
# Frequency-ordered minimizers (minimizer-type 1)
# ---------------------------------------------------------------------------


def census_mmers(bank, minimizer_size: int, max_sample_seqs: int = 50_000,
                 batch: int = 256) -> np.ndarray:
    """Canonical m-mer frequency census over a bank sample
    (MmersFrequency functor, RepartitionAlgorithm.cpp:92-126)."""
    from ..bank.fasta import open_bank
    from ..ops.bitpack import ascii_to_codes_np
    from ..kmer.model import revcomp

    m = minimizer_size
    rg = 1 << (2 * m)
    counts = np.zeros(rg, np.uint32)
    bank = open_bank(bank)
    n_seqs = 0
    for seq in bank:
        n_seqs += 1
        if n_seqs > max_sample_seqs:
            break
        codes, valid = ascii_to_codes_np(
            np.frombuffer(seq.data.encode("ascii"), np.uint8))
        n = len(codes)
        if n < m:
            continue
        # vectorized m-mer values + window validity
        mm = np.zeros(n - m + 1, np.uint64)
        for i in range(m):
            mm = (mm << np.uint64(2)) | codes[i:i + n - m + 1] \
                .astype(np.uint64)
        vcum = np.concatenate([[0], np.cumsum(~valid)])
        ok = (vcum[m:] - vcum[:-m]) == 0
        mm = mm[ok].astype(np.int64)
        if len(mm) == 0:
            continue
        # canonicalize
        from ..ops.bitpack import revcomp_u32
        import jax.numpy as jnp

        rc = np.asarray(revcomp_u32(jnp.asarray(mm.astype(np.uint32)), m))
        canon = np.minimum(mm.astype(np.uint32), rc)
        counts += np.bincount(canon, minlength=rg)[:rg].astype(np.uint32)
    return counts


def freq_order_from_counts(counts: np.ndarray) -> np.ndarray:
    """Frequency ranks, exact port of computeFrequencies
    (RepartitionAlgorithm.cpp:360-384): seen mmers ranked by ascending
    (count, value); unseen set to 4^m; the largest mmer pinned to rank
    4^m - 1 (the 'largest value' sentinel)."""
    rg = len(counts)
    seen = np.nonzero(counts > 0)[0]
    order = np.lexsort((seen, counts[seen]))
    freq = np.full(rg, rg, np.uint32)
    freq[seen[order]] = np.arange(len(seen), dtype=np.uint32)
    freq[rg - 1] = rg - 1
    return freq


def build_freq_order(bank, minimizer_size: int = 10, **kwargs) -> np.ndarray:
    return freq_order_from_counts(
        census_mmers(bank, minimizer_size, **kwargs))
