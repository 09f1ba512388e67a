"""SortingCount: the DSK-equivalent k-mer counting pipeline on the device.

Reference: gatb-core SortingCountAlgorithm (kmer/impl/SortingCountAlgorithm.cpp)
— there, reads are split into superkmers spilled to per-partition files, then
each partition is radix-binned, std::sorted and 453-way-merged
(PartitionsCommand.cpp). Here the same computation is expressed as device
sorts and scans:

  host input pipeline:  bank -> padded (B, L) code/validity batches
  device (jit):         rolling canonical kmer + minimizer extraction
                        (ops/kmer_ops.py), multi-key sort by limb keys,
                        run-detection segment-reduce (ops/sortops.py)
  host merge:           per-batch distinct tables concatenated, one final
                        device sort+reduce pass (partition-invariant, so the
                        result is byte-identical to the reference's
                        concatenated-then-sorted solid table)

Multi-chip: see parallel/exchange.py — reads are sharded over the mesh data
axis and kmers are exchanged via all-to-all on their minimizer partition, the
device equivalent of the reference's minimizer repartition spill (see SURVEY
§2.11).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Iterable

import numpy as np
import jax
import jax.numpy as jnp

from ..bank.fasta import IBank, open_bank
from ..ops.bitpack import ascii_to_codes_np
from ..ops.kmer_ops import extract_kmers, nb_limbs, py_to_limbs, kmers_to_py
from ..ops.sortops import CountTable, count_batch, sort_by_kmer, count_sorted
from .histogram import Histogram

MAX_INT32 = 2**31 - 1


class _RePlan(Exception):
    """Raised mid-count when the live distinct tables exceed the soft HBM
    budget; execute() restarts with doubled passes."""


@dataclass
class CountConfig:
    """Counting parameters (defaults match gatb-core CLI defaults,
    SortingCountAlgorithm.cpp:202-235)."""

    kmer_size: int = 31
    minimizer_size: int = 10
    abundance_min: int | str = 2        # int or "auto"
    abundance_max: int = MAX_INT32
    abundance_min_threshold: int = 2    # floor used when abundance_min="auto"
    histo_max: int = 10000
    solidity_kind: str = "sum"
    # device batching
    batch_reads: int = 1024
    batch_len: int = 256
    # superbatch sizing: G read batches are stacked into one device
    # dispatch (one big sort); bounded by the memory plan in production
    # (ConfigurationAlgorithm volume/max_memory sizing)
    superbatch_rows: int = 1 << 22
    # DSK pass loop (SortingCountAlgorithm.cpp:678, pass filter :806):
    # pass p keeps kmers with minimizer % nb_passes == p, bounding live
    # HBM per pass; results are pass-invariant (tested)
    nb_passes: int = 1
    # progress bar (ProgressTimerAndSystem equivalent) when > 0
    verbose: int = 0
    # ship 2-bit packed words + validity bitmasks to the device (2.25
    # bits/base instead of 16 on the host->device link); packed by the
    # native batcher in C++ or pack_batch_np on the Python fallback
    packed_transfer: bool = True
    # blocked two-level compaction in the superbatch reduce (sortops
    # count_planes(blocked=True)); overflow-flag guarded either way
    blocked_compaction: bool = True
    # fused count+fold accumulator (r5, DEFAULT): every superbatch
    # dispatch extracts + sorts its raw rows and folds them into the
    # device-resident accumulated table with ONE bitonic-merge level in
    # the same program (_superbatch_count_fold) — one dispatch per
    # superbatch, no separate merge chain. Supersedes both the LSM
    # rolling-merge chain (~25 extra dispatches at stress scale) and a
    # carry-accumulator (full O(acc+new) re-sort per fold). False falls
    # back to the LSM chain (kept for A/B and for shapes the fold cannot
    # take).
    carry_accumulator: bool = True
    # streamed final fetch: the per-pass table is packed and fetched in
    # chunks of this many rows on a background thread, overlapping the
    # device->host fetch with the CountProcessor sweep
    fetch_chunk_rows: int = 1 << 23
    # soft HBM budget for the accumulated per-pass distinct tables; when
    # the rolling tables' upper bounds exceed it, execute() aborts and
    # transparently re-plans with twice the passes (optimistic 1-pass
    # execution + transactional re-plan — the device replacement for the
    # reference's disk-volume pass formula, which exists only to bound
    # SPILL FILES; a pass here re-sorts every window, so fewer passes
    # are strictly cheaper while the tables fit)
    table_budget_bytes: int = 6 << 30
    # multi-pass device-resident bank cache budget (bytes): pass 0's
    # staged packed read arrays are kept on device and re-dispatched by
    # later passes (every pass streams the same reads; the filter is
    # on-device) — saves a full re-parse + re-upload per extra pass.
    # 0 disables; the cache auto-drops beyond the budget.
    bank_cache_bytes: int = 2 << 30
    # initial distinct/total ratio guess sizing the FIRST superbatch's
    # table capacity (the reference sizes from the configuration plan's
    # distinct-kmer estimate, ConfigurationAlgorithm.cpp:308; callers
    # with a plan — dbgh5, Graph.create — pass it down); later
    # superbatches learn the measured ratio, overflow guards exactness
    distinct_ratio_hint: float = 0.25

    @property
    def auto_cutoff(self) -> bool:
        return self.abundance_min == "auto"


@dataclass
class CountResult:
    """Output of SortingCount: the solid count table + stats.

    solid_kmers: (N, W) uint32 limb array, ascending integer order
    solid_counts: (N,) int32 abundances
    histogram: full abundance histogram over *distinct* kmers
    info: reference-style properties (kmers_nb_valid, kmers_nb_solid, ...)
    """

    solid_kmers: np.ndarray
    solid_counts: np.ndarray
    histogram: Histogram
    info: dict
    config: CountConfig

    @property
    def nb_solid(self) -> int:
        return len(self.solid_counts)

    def as_dict(self) -> dict[int, int]:
        """Python-int view {kmer_value: count} (small tables / tests only)."""
        return dict(zip(kmers_to_py(self.solid_kmers),
                        self.solid_counts.tolist()))


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _vmask_dense(vmask: np.ndarray, lengths: np.ndarray) -> bool:
    """True iff a packed validity bitmask is exactly the all-in-length
    pattern (no N bases): MSB-first words, expected word j of a read of
    length len = 0xFFFFFFFF << (32 - clip(len - 32j, 0, 32)). Dense
    batches upload None instead of the masks — on a clean bank the
    masks are ~1/3 of the packed transfer bytes."""
    nv = vmask.shape[1]
    j32 = (np.arange(nv, dtype=np.int64) * 32)[None, :]
    rem = np.clip(lengths[:, None].astype(np.int64) - j32, 0, 32)
    exp = ((np.uint64(0xFFFFFFFF) << (32 - rem).astype(np.uint64))
           & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return np.array_equal(vmask, exp)


def _prefetch(gen, depth: int = 4):
    """Run a generator on a background thread with a bounded queue.

    Overlaps host-side batch production (FASTA parse + encode) with device
    dispatch; exceptions propagate to the consumer. If the consumer stops
    early (e.g. a device error), the producer is signalled via a
    cancellation event and joined, so open banks/parsers are released
    promptly instead of leaking for the session lifetime."""
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
    cancel = threading.Event()
    DONE = object()

    def run():
        try:
            for item in gen:
                while not cancel.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue_mod.Full:
                        continue
                if cancel.is_set():
                    return
            q.put(DONE)
        except BaseException as e:  # propagate into the consuming thread
            if not cancel.is_set():
                q.put(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is DONE:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        cancel.set()
        while True:  # drain so a blocked producer can observe the cancel
            try:
                q.get_nowait()
            except queue_mod.Empty:
                break
        t.join(timeout=5.0)


class _BatchBuilder:
    """Packs variable-length reads into fixed-shape (B, L) device batches.

    Reads longer than the length budget are split into overlapping pieces
    with k-1 overlap (window-exact: the set of kmer windows is preserved,
    like the reference's streaming superkmer split over arbitrary-length
    sequences, Sequence2SuperKmer.hpp:139-155).
    """

    def __init__(self, k: int, batch_reads: int, batch_len: int):
        self.k = k
        self.B = batch_reads
        self.L = max(batch_len, 2 * k)
        self.reset()

    def reset(self):
        self.codes = np.zeros((self.B, self.L), np.uint8)
        self.valid = np.zeros((self.B, self.L), bool)
        self.lengths = np.zeros(self.B, np.int32)
        self.row = 0

    def add(self, data: str):
        buf = np.frombuffer(data.encode("ascii"), dtype=np.uint8)
        k, L = self.k, self.L
        pos = 0
        n = len(buf)
        while pos == 0 or pos + k - 1 < n:
            piece = buf[pos:pos + L]
            codes, valid = ascii_to_codes_np(piece)
            m = len(piece)
            self.codes[self.row, :m] = codes
            self.valid[self.row, :m] = valid
            self.lengths[self.row] = m
            self.row += 1
            if self.row == self.B:
                yield self.flush()
            if pos + L >= n:
                break
            pos += L - (k - 1)

    def flush(self):
        out = (self.codes, self.valid, self.lengths, self.row)
        self.reset()
        return out


def _native_fastx_paths(bank) -> list[str] | None:
    """Plain FASTA/FASTQ(.gz) file list of a bank if the native C++ parser
    can serve it (and is buildable), else None."""
    import os

    from ..bank.fasta import BankFasta

    if os.environ.get("GATB_NO_NATIVE"):
        return None
    if not isinstance(bank, BankFasta):
        return None
    try:
        from ..native import available
    except ImportError:
        return None
    return list(bank.paths) if available() else None


import functools


@functools.partial(jax.jit, static_argnames=("k", "m", "nb_passes", "spare"))
def _batch_count_step(codes, valid, lengths, pass_i, *, k: int, m: int,
                      nb_passes: int, spare: bool):
    """One fused device dispatch per batch: extraction + pass filter +
    sort/segment-reduce count + stats scalars. (Splitting these into
    separate calls costs several dispatches per batch.)"""
    kb = extract_kmers(codes, valid, lengths, k, m)
    pv = kb.valid
    if nb_passes > 1:
        # reference pass filter: minimizer % nbPass == pass
        # (SortingCountAlgorithm.cpp:806)
        pv = pv & (kb.minimizer % jnp.uint32(nb_passes)
                   == pass_i.astype(jnp.uint32))
    table = count_batch(kb.kmers, pv, spare_bits=spare)
    n_valid = jnp.sum(kb.valid)
    n_inside = jnp.sum(jnp.maximum(lengths - (k - 1), 0))
    return table.kmers, table.counts, n_valid, n_inside


@functools.partial(jax.jit,
                   static_argnames=("k", "m", "nb_passes", "spare",
                                    "cap_out", "packed", "L", "blocked"))
def _superbatch_count(codes, valid, lengths, pass_i, *, k: int, m: int,
                      nb_passes: int, spare: bool,
                      cap_out: int | None = None,
                      packed: bool = False, L: int | None = None,
                      blocked: bool = False):
    """One device dispatch for a whole superbatch (G stacked read batches):
    extraction (lax.map, bounding live temporaries) + pass filter + ONE
    plane sort (exact row count — lax.sort needs no pow2 padding) +
    scatter-free distinct reduce.

    Replaces the round-1 per-batch sort + deep merge tree: sorting a few
    large arrays amortizes the sort's memory passes and the big
    sort dedups ~coverage-x duplicates in one reduce. This mirrors the
    reference's per-partition sort granularity (PartitionsCommand.cpp:
    1474-1505) rather than its read-batch granularity.

    codes/valid: (G, B, L) bytes, or with packed=True the packed words /
    validity bitmasks ((G, B, ceil(L/16)) / (G, B, ceil(L/32)) uint32,
    pack_words layout) with L the unpacked length; lengths: (G, B).
    Returns (planes tuple of (cap,), counts, n, n_valid, n_inside).
    """
    from ..ops.kmer_ops import extract_kmers_packed
    from ..ops.sortops import count_planes

    w = nb_limbs(k)

    def ext(args):
        c, v, l = args
        if packed:
            kb = extract_kmers_packed(c, v, l, k, L, m,
                                      with_minimizers=nb_passes > 1)
        else:
            kb = extract_kmers(c, v, l, k, m,
                               with_minimizers=nb_passes > 1)
        pv = kb.valid
        if nb_passes > 1:
            pv = pv & (kb.minimizer % jnp.uint32(nb_passes)
                       == pass_i.astype(jnp.uint32))
        planes = tuple(kb.kmers[..., j].reshape(-1) for j in range(w))
        return planes, pv.reshape(-1), jnp.sum(kb.valid)

    planes, pv, nvs = jax.lax.map(ext, (codes, valid, lengths))
    flat = tuple(p.reshape(-1) for p in planes)
    fv = pv.reshape(-1)
    n_valid = jnp.sum(nvs)
    n_inside = jnp.sum(jnp.maximum(lengths - (k - 1), 0))
    out_p, counts, n, overflow = count_planes(flat, fv, spare_bits=spare,
                                              cap_out=cap_out,
                                              blocked=blocked)
    return out_p, counts, n, overflow, n_valid, n_inside


@functools.partial(jax.jit, static_argnames=("w", "cap"))
def _empty_table_jit(*, w: int, cap: int):
    """ONE dispatch materializing an empty (cap,) distinct table (planes
    of all-ones sentinels + zero counts + n=0) — each out-of-jit
    jnp.full/zeros would be its own dispatch."""
    planes = tuple(jnp.full((cap,), jnp.uint32(0xFFFFFFFF))
                   for _ in range(w))
    return planes, jnp.zeros((cap,), jnp.int32), jnp.int32(0)


@functools.partial(jax.jit,
                   static_argnames=("k", "m", "nb_passes", "spare",
                                    "packed", "L", "blocked", "cap_acc",
                                    "cap_out"),
                   donate_argnums=(4, 5))
def _superbatch_count_fold(codes, valid, lengths, pass_i, acc_planes,
                           acc_counts, acc_n, reset, *, k: int, m: int,
                           nb_passes: int, spare: bool,
                           packed: bool, L: int | None, blocked: bool,
                           cap_acc: int, cap_out: int | None = None):
    """Fused count+fold superbatch step (r5): extraction + raw sort +
    ONE bitonic-merge level against the device-resident accumulated
    table + a single distinct reduce, all in one dispatch.

    A carry-accumulator would pay a FULL re-sort of (acc + new) per
    superbatch; here the raw superbatch rows are sorted once (they must
    be anyway) and folded into the acc with a bitonic MERGE network —
    log2(2*cap) elementwise stages instead of ~log2(cap)^2/2 sort
    stages — skipping the per-superbatch intermediate compaction
    entirely. One dispatch per superbatch, zero separate merge
    dispatches (the LSM chain needs ~25 at stress scale).

    The raw rows (weight 1 each) are padded to cap_acc so (acc, raw)
    form two equal sorted runs; sentinels are all-ones keys (a CANONICAL
    kmer can never be all-ones for any k — sortops._encode_invalid
    note). ``reset`` (traced bool) treats the incoming acc as empty so a
    new pass can reuse the previous pass's arrays without re-allocating.

    Two fold shapes, selected by the driver from the measured
    distinct/rows ratio:

    - ``cap_out=None`` (raw mode, high-ratio banks like the 30M-stress):
      the sorted raw rows pad to cap_acc and merge directly — no
      intermediate compaction, merge cost O(cap_acc)=O(rows).
    - ``cap_out=C`` (compact mode, coverage-heavy banks): the raw rows
      first reduce to their distinct table at capacity C, then THAT
      merges with the acc — merge cost O(max(cap_acc, C)) = O(distinct),
      which at 30x coverage is ~20x less than O(rows) (the r5 raw-only
      fold regressed the bench e2e 4x this way).

    Transactional: if either capacity overflows, the incoming acc is
    returned unchanged (the host replays this superbatch with grown
    capacities). Replaces the reference's per-partition sort + 453-way
    KxmerPointer merge (PartitionsCommand.cpp:1206-1227, 1600-1800)
    with sort + merge-network + scan reduce.

    Returns (acc_planes', acc_counts', acc_n', flags (2,) int32
    [out_ovf, acc_ovf], n_local, n_valid, n_inside)."""
    from ..ops.kmer_ops import extract_kmers_packed
    from ..ops.sortops import _merge_sorted_runs, count_sorted_planes

    w = nb_limbs(k)

    def ext(args):
        c, v, l = args
        if packed:
            kb = extract_kmers_packed(c, v, l, k, L, m,
                                      with_minimizers=nb_passes > 1)
        else:
            kb = extract_kmers(c, v, l, k, m,
                               with_minimizers=nb_passes > 1)
        pv = kb.valid
        if nb_passes > 1:
            pv = pv & (kb.minimizer % jnp.uint32(nb_passes)
                       == pass_i.astype(jnp.uint32))
        planes = tuple(kb.kmers[..., j].reshape(-1) for j in range(w))
        return planes, pv.reshape(-1), jnp.sum(kb.valid)

    planes, pv, nvs = jax.lax.map(ext, (codes, valid, lengths))
    flat = tuple(p.reshape(-1) for p in planes)
    fv = pv.reshape(-1)
    n_valid = jnp.sum(nvs)
    n_inside = jnp.sum(jnp.maximum(lengths - (k - 1), 0))
    rows = flat[0].shape[0]
    if cap_out is None and rows > cap_acc:
        raise ValueError(f"fold(raw): superbatch rows {rows} > cap_acc "
                         f"{cap_acc}")
    # sentinel-encode invalid windows (canonical kmers are never
    # all-ones) and sort the raw rows — the sort that any counting
    # scheme pays
    enc = tuple(jnp.where(fv, p, jnp.uint32(0xFFFFFFFF)) for p in flat)
    nv = jnp.sum(fv).astype(jnp.int32)
    sraw = jax.lax.sort(enc, num_keys=w)
    if cap_out is not None:
        # compact-first: reduce the raw rows to their distinct table
        sidx = jax.lax.broadcasted_iota(jnp.int32, (rows,), 0)
        raw_p, raw_c, n_loc, ovf_out = count_sorted_planes(
            sraw, sidx >= nv, cap_out=cap_out, blocked=blocked)
        n_new = jnp.minimum(n_loc, jnp.int32(cap_out))
        run = max(cap_acc, cap_out)
    else:
        raw_p, raw_c = sraw, None
        n_loc = nv
        n_new = nv
        ovf_out = jnp.bool_(False)
        run = cap_acc
    # pad both sorted runs to a common pow2 length
    padn = run - raw_p[0].shape[0]
    if padn:
        raw_p = tuple(jnp.concatenate(
            [p, jnp.full((padn,), jnp.uint32(0xFFFFFFFF))])
            for p in raw_p)
        if raw_c is not None:
            raw_c = jnp.concatenate([raw_c, jnp.zeros((padn,),
                                                      jnp.int32)])
    if raw_c is None:
        ridx = jax.lax.broadcasted_iota(jnp.int32, (run,), 0)
        raw_c = jnp.where(ridx < nv, jnp.int32(1), jnp.int32(0))
    # effective acc (reset => empty); rows past acc_n are sentinels by
    # construction of the reduce below
    acc_n_eff = jnp.where(reset, jnp.int32(0), acc_n)
    accp = tuple(jnp.where(reset, jnp.uint32(0xFFFFFFFF), p)
                 for p in acc_planes)
    accc = jnp.where(reset, jnp.int32(0), acc_counts)
    pada = run - cap_acc
    if pada:
        accp = tuple(jnp.concatenate(
            [p, jnp.full((pada,), jnp.uint32(0xFFFFFFFF))])
            for p in accp)
        accc = jnp.concatenate([accc, jnp.zeros((pada,), jnp.int32)])
    # ONE bitonic merge level over the two sorted runs; counts ride as
    # the least-significant key plane (summed per run downstream, so
    # their order within equal-kmer runs is irrelevant)
    cat = tuple(jnp.concatenate([a, b]) for a, b in zip(accp, raw_p))
    catw = jnp.concatenate([accc, raw_c]).astype(jnp.uint32)
    merged = _merge_sorted_runs(cat + (catw,), run=run)
    midx = jax.lax.broadcasted_iota(jnp.int32, (2 * run,), 0)
    inv = midx >= (acc_n_eff + n_new)
    out_p, out_c, n2, ovf_acc = count_sorted_planes(
        merged[:w], inv, weights=merged[w].astype(jnp.int32),
        cap_out=cap_acc, blocked=blocked)
    ovf = ovf_out | ovf_acc
    keep_p = tuple(jnp.where(ovf, a[:cap_acc], b)
                   for a, b in zip(accp, out_p))
    keep_c = jnp.where(ovf, accc[:cap_acc], out_c)
    keep_n = jnp.where(ovf, acc_n_eff, n2)
    flags = jnp.stack([ovf_out, ovf_acc]).astype(jnp.int32)
    return keep_p, keep_c, keep_n, flags, n_loc, n_valid, n_inside



from ..misc.algorithm import Algorithm


class SortingCount(Algorithm):
    """Driver for the counting pipeline (SortingCountAlgorithm equivalent),
    on the Algorithm execute()/run()/get_info() contract
    (Algorithm.hpp:8-120 — `run(bank)` stamps exec_time + the stopwatch
    tree into get_info(), the executeAlgorithm wrapper pattern).

    ``processor`` plugs a custom CountProcessor (kmer/count_processor.py,
    the ICountProcessor.hpp:92-200 extension point) into the run: it
    joins the processor vector as its own sweep, receiving every pass's
    kmer-complete table with full lifecycle calls — the reference
    SortingCountAlgorithm(..., processor) constructor parameter."""

    def __init__(self, config: CountConfig | None = None, processor=None):
        super().__init__("dsk")
        self.config = config or CountConfig()
        self.processor = processor

    @staticmethod
    def _program_cache_size() -> int:
        """Total compiled-program cache entries across the counting
        kernels — the per-run delta lands in info["nb_device_programs"]
        so shape discipline is a tracked metric (each distinct shape is
        a fresh compile)."""
        total = 0
        for fn in (_superbatch_count, _superbatch_count_fold,
                   _empty_table_jit, _merge_jit, _pack_table_jit,
                   _pack_table_chunk_jit):
            try:
                total += fn._cache_size()
            except Exception:
                pass
        return total

    def execute(self, bank) -> CountResult:
        """Optimistic pass execution: runs with cfg.nb_passes, and if the
        accumulated distinct tables blow the soft HBM budget mid-run,
        restarts with doubled passes (exact either way — the pass filter
        partitions kmers)."""
        nb_passes = max(1, int(self.config.nb_passes))
        while True:
            try:
                return self._execute(bank, nb_passes)
            except _RePlan as rp:
                nb_passes *= 2
                if nb_passes > 64:
                    raise RuntimeError(
                        "counting re-plan exceeded 64 passes") from rp

    def _execute(self, bank, nb_passes: int) -> CountResult:
        cfg = self.config
        bank = open_bank(bank)
        k = cfg.kmer_size
        w = nb_limbs(k)
        t0 = time.time()
        programs0 = self._program_cache_size()

        builder = _BatchBuilder(k, cfg.batch_reads, cfg.batch_len)
        valid_scalars: list = []
        inside_scalars: list = []
        nb_seq = 0
        seq_total_size = 0
        # BankStats block (SortingCountAlgorithm.cpp:735-742)
        seq_min = [-1]
        seq_max = [0]
        seq_sumsq = [0.0]
        spare = (2 * k) % 32 != 0
        native_paths = _native_fastx_paths(bank)
        # soft budget: STORED bytes per live table row (limb planes +
        # counts); sort transients are bounded separately by
        # cfg.superbatch_rows and do not persist across superbatches
        row_bytes = 4 * w + 4
        budget_rows = max(cfg.table_budget_bytes // row_bytes, 1024)

        rows_per_batch = cfg.batch_reads * (builder.L - k + 1)
        G = max(1, int(cfg.superbatch_rows) // rows_per_batch)

        packed = bool(cfg.packed_transfer)

        def produce(count_stats: bool):
            """Host batch stream (parse + 2-bit encode [+ pack]). Runs on a
            producer thread so parsing overlaps device compute — the
            device-side analogue of the reference's Dispatcher thread fan-out over the
            sequence iterator (SortingCountAlgorithm.cpp:1271)."""
            nonlocal nb_seq, seq_total_size
            if native_paths is not None:
                # native C++ parse+encode+batch path (native/fastx.cpp),
                # batch shapes identical to _BatchBuilder (equivalence-
                # tested); the C call releases the GIL
                from ..native import NativeBatcher

                for path in native_paths:
                    nat = NativeBatcher(path, k, cfg.batch_reads, builder.L)
                    it = nat.iter_packed() if packed else iter(nat)
                    for batch in it:
                        yield batch
                    if count_stats:
                        s_n, s_t, s_mn, s_mx, s_sq = nat.stats_full()
                        nb_seq += s_n
                        seq_total_size += s_t
                        if s_n:
                            seq_min[0] = s_mn if seq_min[0] < 0 \
                                else min(seq_min[0], s_mn)
                            seq_max[0] = max(seq_max[0], s_mx)
                            seq_sumsq[0] += s_sq
            else:
                from ..ops.bitpack import pack_batch_np

                def emit(batch):
                    if not packed:
                        return batch
                    codes, val, lens, row = batch
                    words, vmask = pack_batch_np(codes, val)
                    return words, vmask, lens, row

                for seq in bank:
                    if count_stats:
                        nb_seq += 1
                        L = len(seq)
                        seq_total_size += L
                        seq_min[0] = L if seq_min[0] < 0 \
                            else min(seq_min[0], L)
                        seq_max[0] = max(seq_max[0], L)
                        seq_sumsq[0] += float(L) * L
                    for batch in builder.add(seq.data):
                        yield emit(batch)
                if builder.row:
                    yield emit(builder.flush())

        # per-pass lists of (planes tuple, counts, n) distinct tables,
        # rolling-merged so device memory stays bounded: <= _MAX_LIVE
        # tables during a pass, ONE accumulated table per finished pass
        # (the round-3 stress run proved end-deferred merging OOMs HBM
        # at ~66 superbatch tables)
        tables: dict[int, list] = {}
        host_tables: dict[int, tuple] = {}   # pass -> fetched (kmers, counts)
        n_resolved = [0]
        _MAX_LIVE_LSM = 10   # hard cap on live per-pass tables
        # adaptive distinct-ratio estimate: start from the caller's plan
        # hint, learn from each superbatch's measured n/rows so
        # low-coverage banks stop paying the overflow re-run
        dedup_ratio = {"est": float(cfg.distinct_ratio_hint)}
        # per-phase stopwatches (TimeInfo equivalent; reference dsk emits
        # fill_partitions / fill_solid_kmers + 1.read/2.sort/3.dump,
        # PartitionsCommand.cpp:1229-1235)
        from ..misc.time_info import TimeInfo, Progress

        ti = TimeInfo()
        try:
            est_n, est_total, _ = bank.estimate()
            est_batches = max(1, est_total // max(
                cfg.batch_reads * builder.L, 1) + 1)
        except Exception:
            est_batches = 1
        progress = Progress(est_batches * nb_passes,
                            "DSK: counting kmers",
                            verbose=cfg.verbose > 0)

        pending: list = []  # dispatched superbatches awaiting resolution
        # multi-pass device-resident bank cache: every DSK pass streams
        # the SAME packed reads (the pass filter is on-device), so pass 0
        # keeps its staged device arrays and later passes dispatch off
        # them — no re-parse, no re-upload (at stress scale the packed
        # bank is ~250 MB vs ~20 s of parse + link per extra pass).
        # Budget-gated: the cache is dropped the moment it would exceed
        # cfg.bank_cache_bytes of HBM.
        bank_cache: list | None = [] if nb_passes > 1 else None
        cache_bytes = [0]

        # ---- fused count+fold accumulator state (r5) -------------------
        # one dispatch per superbatch (_superbatch_count_fold): the
        # sorted raw rows fold into the device-resident per-pass table
        # via one bitonic merge level — no separate merge dispatches.
        # The in-flight window stays 3 deep (the overflow flag is
        # checked lazily at resolve time, so dispatches pipeline); an
        # overflowed superbatch was NOT committed (transactional fold),
        # so it is replayed from its staged inputs on a doubled
        # accumulator, the pre-growth acc is parked, and parked accs
        # fold back in at pass end with one merge dispatch each.
        use_fold = bool(cfg.carry_accumulator)
        cap0 = _next_pow2(max(G * rows_per_batch, 256))
        if use_fold:
            while G > 1 and cap0 > budget_rows:
                G //= 2
                cap0 = _next_pow2(max(G * rows_per_batch, 256))
            if cap0 > budget_rows:
                use_fold = False  # tiny budget: LSM compacts per batch
        fold = {"p": None, "c": None, "n": None, "cap": 0,
                "reset": True, "parked": [], "replay": [],
                "growing": False, "n_known": 0, "used": False}
        cap_budget = max(_next_pow2(budget_rows), 1024)

        def fold_arrays(cap: int):
            fold["p"], fold["c"], fold["n"] = _empty_table_jit(
                w=w, cap=cap)
            fold["cap"] = cap
            fold["reset"] = False
            fold["used"] = False

        def fold_park_and_grow(newcap: int):
            """Drain the window, park the committed acc, continue on a
            fresh accumulator of ``newcap`` rows (parked accs fold back
            in at pass end — proactive growth, no replays)."""
            if newcap > cap_budget:
                raise _RePlan(nb_passes)
            while pending:
                fold_resolve(pending.pop(0))
            if fold["p"] is not None and fold["used"]:
                fold["parked"].append((fold["p"], fold["c"], fold["n"]))
            fold_arrays(newcap)

        def fold_caps(rows: int):
            """(cap_out | None, capR) for a superbatch of ``rows`` raw
            rows: compact-first when the learned distinct ratio says the
            per-superbatch table is far below the raw row count."""
            capR = _next_pow2(max(rows, 256))
            est = dedup_ratio["est"]
            co = _next_pow2(max(256, min(rows, int(rows * est * 1.5))))
            return (co if co <= capR // 4 else None), capR

        def fold_dispatch(codes, valid, lengths, pass_i, count_stats,
                          g_len):
            rows = codes.shape[0] * rows_per_batch
            cap_out_d, capR = fold_caps(rows)
            if fold["p"] is None:
                # fresh pass: raw mode needs room for the raw rows;
                # compact mode sizes from the distinct estimate with 4x
                # headroom; a previous pass's grown capacity is kept
                init = capR if cap_out_d is None else \
                    min(capR, max(4 * cap_out_d, 1 << 12))
                fold_arrays(max(fold["cap"], init))
            elif cap_out_d is None and fold["cap"] < capR:
                # mode flipped to raw mid-run: the acc must hold raw rows
                fold_park_and_grow(capR)
            elif cap_out_d is not None and fold["used"] \
                    and fold["cap"] < capR \
                    and fold["n_known"] + 3 * cap_out_d > fold["cap"]:
                # proactive: the (lagged) live count plus the in-flight
                # window could overflow — grow now, without replays
                fold_park_and_grow(
                    min(capR, max(fold["cap"] * 2,
                                  _next_pow2(fold["n_known"]
                                             + 4 * cap_out_d))))
            out = _superbatch_count_fold(
                codes, valid, lengths, jnp.int32(pass_i),
                fold["p"], fold["c"], fold["n"],
                jnp.bool_(fold["reset"]),
                k=k, m=cfg.minimizer_size, nb_passes=nb_passes,
                spare=spare, packed=packed,
                L=builder.L if packed else None,
                blocked=bool(cfg.blocked_compaction),
                cap_acc=fold["cap"], cap_out=cap_out_d)
            keep_p, keep_c, keep_n, flags, n_loc, nv, ni = out
            fold["p"], fold["c"], fold["n"] = keep_p, keep_c, keep_n
            fold["reset"] = False
            fold["used"] = True
            pending.append((flags, n_loc, keep_n, nv, ni,
                            (codes, valid, lengths), pass_i,
                            count_stats, g_len, rows,
                            cap_out_d is not None))
            # window 2 (not the LSM path's 3): each in-flight fold keeps
            # a full acc generation (~cap_acc rows) alive in HBM
            while len(pending) > 2:
                fold_resolve(pending.pop(0))

        def fold_resolve(item):
            (flags, n_loc, keep_n, nv, ni, staged, pass_i, count_stats,
             g_len, rows, compact) = item
            with ti.section("2.sort"):
                fl, nl, kn, nvv, niv = jax.device_get(
                    (flags, n_loc, keep_n, nv, ni))
            if count_stats:
                valid_scalars.append(int(nvv))
                inside_scalars.append(int(niv))
            if fl.any():
                if fl[0]:   # cap_out too small: raise the ratio estimate
                    dedup_ratio["est"] = min(
                        1.0, max(dedup_ratio["est"] * 2, int(nl) / rows))
                fold["replay"].append((staged, pass_i, bool(fl[1])))
            else:
                fold["n_known"] = max(fold["n_known"], int(kn))
                if compact:
                    dedup_ratio["est"] = max(dedup_ratio["est"],
                                             int(nl) / rows)
                elif n_resolved[0] == 0:
                    # first raw superbatch onto an empty acc: keep_n IS
                    # its distinct count — calibrate the ratio
                    dedup_ratio["est"] = max(dedup_ratio["est"],
                                             int(kn) / rows)
            n_resolved[0] += 1
            progress.inc(g_len)

        def fold_grow_and_replay():
            """Overflow seen: drain the window (collecting any further
            overflows), park the committed acc, grow the blown
            capacity, replay the uncommitted superbatches."""
            fold["growing"] = True
            try:
                while pending:
                    fold_resolve(pending.pop(0))
                while fold["replay"]:
                    replays, fold["replay"] = fold["replay"], []
                    if any(acc_ovf for _, _, acc_ovf in replays):
                        newcap = fold["cap"] * 2
                        if newcap > cap_budget:
                            raise _RePlan(nb_passes)
                        if fold["p"] is not None and fold["used"]:
                            fold["parked"].append(
                                (fold["p"], fold["c"], fold["n"]))
                        fold_arrays(newcap)
                    for staged, pi, _ in replays:
                        fold_dispatch(*staged, pi, False,
                                      staged[0].shape[0])
                    while pending:
                        fold_resolve(pending.pop(0))
            finally:
                fold["growing"] = False

        def fold_end_pass(pass_i):
            from ..ops.sortops import merge_tables_planes as _mtp

            while pending:
                fold_resolve(pending.pop(0))
            if fold["replay"]:
                fold_grow_and_replay()
            with ti.section("3.merge"):
                for (pp, pc, pn) in fold["parked"]:
                    while True:
                        planes_m, counts_m, n_m, ovf_m = _mtp(
                            tuple(pp), pc, _as_i32(pn),
                            tuple(fold["p"]), fold["c"],
                            _as_i32(fold["n"]), cap_out=fold["cap"])
                        if not bool(np.asarray(ovf_m)):
                            break
                        if fold["cap"] * 2 > cap_budget:
                            raise _RePlan(nb_passes)
                        fold["cap"] *= 2
                    fold["p"], fold["c"], fold["n"] = \
                        planes_m, counts_m, n_m
                fold["parked"] = []
                if fold["p"] is None:
                    host_tables[pass_i] = _MaterialTable(
                        np.zeros((0, w), np.uint32),
                        np.zeros((0,), np.int32))
                else:
                    n = int(np.asarray(fold["n"]))
                    host_tables[pass_i] = _StreamedTable(
                        fold["p"], fold["c"], n, w,
                        chunk_rows=cfg.fetch_chunk_rows)
            # the streamed fetch still reads these buffers and the fold
            # dispatch DONATES its acc arguments, so the next pass must
            # start from fresh arrays, not reuse-with-reset
            fold["p"] = fold["c"] = fold["n"] = None
            fold["reset"] = True
            fold["n_known"] = 0

        def resolve(item):
            """Sync point of one superbatch: overflow check (+ exact rerun
            at full capacity when tripped), stats, trim, ratio update."""
            out, rows, inputs, pass_i, first_pass, g_len = item
            with ti.section("2.sort"):
                # ONE round trip for all of this superbatch's scalars
                # (overflow flag, n, valid/inside counts)
                ov, n, nv, ni = jax.device_get(
                    (out[3], out[2], out[4], out[5]))
                if bool(ov):  # overflow: rerun unbounded (always exact)
                    codes, valid, lengths = inputs
                    out = _superbatch_count(
                        codes, valid, lengths, jnp.int32(pass_i),
                        k=k, m=cfg.minimizer_size, nb_passes=nb_passes,
                        spare=spare, cap_out=None, packed=packed,
                        L=builder.L if packed else None)
                    n, nv, ni = jax.device_get((out[2], out[4], out[5]))
                    # the unbounded table's capacity is the raw row count
                    # (non-pow2); merges need pow2 capacities + sentinel
                    # tails, so pad this rare path up to the next pow2
                    from ..ops.sortops import pad_planes_pow2

                    pp, pc, _ = pad_planes_pow2(out[0], out[1])
                    out = (pp, pc) + tuple(out[2:])
                out_p, counts = out[0], out[1]
                if first_pass:
                    valid_scalars.append(int(nv))
                    inside_scalars.append(int(ni))
                n = int(n)
                dedup_ratio["est"] = max(dedup_ratio["est"], n / rows)
            lst = tables.setdefault(pass_i, [])
            # no eager trim (each out-of-jit slice is a dispatched device
            # op): rows past n are sentinel, merges mask them; ub = n
            lst.append((out_p, counts, n, n))
            if sum(t[3] for t in lst) > budget_rows:
                # bounds are no-dedup sums; collapse every bound to the
                # exact n before concluding the pass really blew the
                # budget (review r4: high-overlap banks would otherwise
                # spuriously cascade re-plans)
                lst[:] = [(p, c, nn, int(np.asarray(nn)))
                          for (p, c, nn, _u) in lst]
                if sum(t[3] for t in lst) > budget_rows:
                    raise _RePlan(nb_passes)
            n_resolved[0] += 1
            with ti.section("3.merge"):
                # LSM-style size-classed merging (r4): only merge the two
                # smallest tables while they are in the same size class.
                # An accumulate-into-one policy re-sorts the big table
                # once per superbatch — O(N*P) rows; the binary-counter
                # tree is O(N*log P) with <= ~log2(P)+2 live tables
                while len(lst) >= 2:
                    lst.sort(key=lambda t: t[3])
                    if len(lst) <= _MAX_LIVE_LSM \
                            and lst[1][3] > 2 * lst[0][3]:
                        break
                    _merge_smallest_pair(lst)
            progress.inc(g_len)

        def flush_group(group, pass_i, first_pass):
            """One superbatch dispatch: stack G batches, count (async)."""
            g = len(group)
            if g < G:
                # pad the tail group: fold mode pads to G itself (the
                # tail then reuses the main superbatch's compiled
                # program — zero extra compiles); the
                # LSM path keeps the next-pow2 rule its capacity sizing
                # expects
                gp = G if use_fold else _next_pow2(g)
                B = group[0][0].shape[0]
                c_shape = group[0][0].shape
                v_shape = group[0][1].shape
                c_dt = group[0][0].dtype
                v_dt = group[0][1].dtype
                while len(group) < gp:
                    group.append((np.zeros(c_shape, c_dt),
                                  np.zeros(v_shape, v_dt),
                                  np.zeros((B,), np.int32), 0))
            with ti.section("1.stack"):
                codes = jnp.asarray(np.stack([b[0] for b in group]))
                # dense transfer (fold+packed): a clean bank's all-ones
                # validity masks are ~1/3 of the upload bytes — send
                # None and let extraction use the in-length rule
                if use_fold and packed and all(
                        _vmask_dense(b[1], b[2]) for b in group):
                    valid = None
                else:
                    valid = jnp.asarray(np.stack([b[1] for b in group]))
                lengths = jnp.asarray(np.stack([b[2] for b in group]))
            nonlocal_cache = bank_cache
            if nonlocal_cache is not None and pass_i == 0:
                nb = codes.nbytes + lengths.nbytes \
                    + (0 if valid is None else valid.nbytes)
                if cache_bytes[0] + nb <= cfg.bank_cache_bytes:
                    nonlocal_cache.append((codes, valid, lengths))
                    cache_bytes[0] += nb
                else:           # budget exceeded: drop the whole cache
                    nonlocal_cache.clear()
                    drop_cache()
            if use_fold:
                fold_dispatch(codes, valid, lengths, pass_i,
                              first_pass, g)
                if fold["replay"] and not fold["growing"]:
                    fold_grow_and_replay()
                return
            rows = codes.shape[0] * rows_per_batch
            # distinct-table capacity: coverage makes distinct << rows;
            # the ratio is learned from each superbatch's measured n/rows
            # (with 1.5x headroom) and the overflow flag guards exactness
            # (fallback re-runs at full capacity) — same role as the
            # plan's distinct-kmer estimate in the reference
            # (ConfigurationAlgorithm.cpp:308)
            cap_out = _next_pow2(max(
                256, min(rows, int(rows * dedup_ratio["est"] * 1.5))))
            out = _superbatch_count(
                codes, valid, lengths, jnp.int32(pass_i),
                k=k, m=cfg.minimizer_size, nb_passes=nb_passes,
                spare=spare, cap_out=cap_out, packed=packed,
                L=builder.L if packed else None,
                blocked=bool(cfg.blocked_compaction))
            pending.append((out, rows, (codes, valid, lengths), pass_i,
                            first_pass, len(group)))
            # resolve the FIRST superbatch immediately (learn the distinct
            # ratio before sizing the next); after that keep up to 3 in
            # flight so host parse + transfer overlap device compute and
            # the per-dispatch latency stays hidden
            while len(pending) > (0 if n_resolved[0] == 0 else 3):
                resolve(pending.pop(0))

        def drop_cache():
            nonlocal bank_cache
            bank_cache = None

        def end_pass(pass_i):
            """Pass boundary: drain + fold this pass down to ONE table and
            FETCH it to host — device memory holds at most the active
            pass's tables, so the _RePlan budget actually bounds HBM
            (review r4: finished passes used to stay device-resident)."""
            while pending:
                resolve(pending.pop(0))
            with ti.section("3.merge"):
                lst = tables.get(pass_i, [])
                while len(lst) > 1:
                    _merge_smallest_pair(lst)
                if lst:
                    planes_d, counts_d, n_d, _ = lst[0]
                    host_tables[pass_i] = _MaterialTable(*_fetch_table(
                        planes_d, counts_d, int(np.asarray(n_d)), w))
                    lst.clear()
                else:
                    host_tables[pass_i] = _MaterialTable(
                        np.zeros((0, w), np.uint32),
                        np.zeros((0,), np.int32))

        def dispatch_staged(codes, valid, lengths, pass_i):
            """flush_group's tail for already-staged device arrays."""
            rows = codes.shape[0] * rows_per_batch
            cap_out = _next_pow2(max(
                256, min(rows, int(rows * dedup_ratio["est"] * 1.5))))
            out = _superbatch_count(
                codes, valid, lengths, jnp.int32(pass_i),
                k=k, m=cfg.minimizer_size, nb_passes=nb_passes,
                spare=spare, cap_out=cap_out, packed=packed,
                L=builder.L if packed else None,
                blocked=bool(cfg.blocked_compaction))
            pending.append((out, rows, (codes, valid, lengths), pass_i,
                            False, codes.shape[0]))
            while len(pending) > 3:
                resolve(pending.pop(0))

        # DSK pass loop (SortingCountAlgorithm.cpp:678): pass p keeps kmers
        # with minimizer % nb_passes == p; each pass streams the whole bank
        # and bounds live device memory to its own superbatch.
        for pass_i in range(nb_passes):
            first_pass = pass_i == 0
            if not first_pass and bank_cache is not None:
                for staged in bank_cache:      # device-resident reuse
                    if use_fold:
                        fold_dispatch(*staged, pass_i, False,
                                      staged[0].shape[0])
                        if fold["replay"] and not fold["growing"]:
                            fold_grow_and_replay()
                    else:
                        dispatch_staged(*staged, pass_i)
                if use_fold:
                    fold_end_pass(pass_i)
                else:
                    end_pass(pass_i)
                continue
            group: list = []
            for batch in _prefetch(produce(first_pass), depth=4):
                group.append(batch)
                if len(group) == G:
                    flush_group(group, pass_i, first_pass)
                    group = []
            if group:
                flush_group(group, pass_i, first_pass)
            if use_fold:
                fold_end_pass(pass_i)
            else:
                end_pass(pass_i)

        t_fill = time.time() - t0
        progress.finish()

        # each pass yields ONE kmer-complete table (passes partition
        # kmers by minimizer, so a pass table is the reference's notion
        # of a completed partition); fold-mode tables stream from the
        # device in chunks concurrently with the processor sweep below
        t1 = time.time()
        parts: list[tuple[int, object]] = []
        for p in range(nb_passes):
            st = host_tables.get(p)
            if st is None:
                st = _MaterialTable(np.zeros((0, w), np.uint32),
                                    np.zeros((0,), np.int32))
            parts.append((p, st))
        kmers_nb_valid = int(sum(int(np.asarray(v))
                                 for v in valid_scalars))
        kmers_nb_invalid = int(sum(int(np.asarray(v))
                                   for v in inside_scalars)) \
            - kmers_nb_valid
        t_merge = time.time() - t1

        # Note: overlap-split pieces can double-count boundary kmers only if
        # a kmer window appears in two pieces; the k-1 overlap yields each
        # window exactly once, so plain summation is exact.

        # ---- count processor vector (ICountProcessor.hpp:92-200) --------
        # Default = histogram -> solidity -> collect, expressed as the
        # plugin chain; with "auto" abundance the histogram runs as its
        # own sweep first, exactly the reference's cutoff-processor +
        # dsk-processor vector (SortingCountAlgorithm.cpp:468-510).
        from .count_processor import (
            CountProcessorChain, CountProcessorCollect,
            CountProcessorHistogram, CountProcessorSolidity)

        hist_proc = CountProcessorHistogram(cfg.histo_max,
                                            cfg.abundance_min_threshold)
        amax = cfg.abundance_max
        if cfg.auto_cutoff:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (0, amax), auto_histogram=hist_proc)
        else:
            solidity = CountProcessorSolidity(
                cfg.solidity_kind, (int(cfg.abundance_min), amax))
        collect = CountProcessorCollect()
        if cfg.auto_cutoff:
            vector = [CountProcessorChain(hist_proc),
                      CountProcessorChain(solidity, collect)]
        else:
            vector = [CountProcessorChain(hist_proc, solidity, collect)]
        if self.processor is not None:
            vector.append(self.processor)

        with ti.section("4.process"):
            for proc in vector:
                proc.begin(cfg)
                clones = []
                for p, st in parts:
                    proc.begin_pass(p)
                    c = proc.clone()
                    # chunks of a sorted distinct table are disjoint
                    # key ranges, so each streams through as its own
                    # part (the reference likewise feeds many
                    # partitions per pass to each clone); the first
                    # sweep overlaps the device fetch
                    for ci, (uniq_c, counts_c) in enumerate(st.iter()):
                        c.begin_part(p, ci, 0, "superbatch")
                        c.process_table(p, uniq_c, counts_c[:, None],
                                        counts_c)
                        c.end_part(p, ci)
                    clones.append(c)
                    proc.end_pass(p)
                proc.finish_clones(clones)
                proc.end()

        solid_kmers, _, solid_sums = collect.result(w)
        solid_counts = solid_sums.astype(np.int32)
        histogram = hist_proc.histogram
        amin = solidity.resolve_cutoff()
        if not cfg.auto_cutoff:
            histogram.cutoff = amin
        histogram.nb_solids_after_cutoff = len(solid_counts)
        nb_distinct = int(sum(st.n for _, st in parts))

        info = {
            "kmers_nb_distinct": nb_distinct,
            "kmers_nb_solid": int(len(solid_counts)),
            "kmers_nb_weak": int(nb_distinct - len(solid_counts)),
            "kmers_nb_valid": int(kmers_nb_valid),
            "kmers_nb_invalid": int(kmers_nb_invalid),
            "sequences_number": int(nb_seq),
            "sequences_size": int(seq_total_size),
            # seq_size_* (BankStats, SortingCountAlgorithm.cpp:735-742)
            "seq_size_min": int(max(seq_min[0], 0)),
            "seq_size_max": int(seq_max[0]),
            "seq_size_mean": round(seq_total_size / nb_seq, 1)
            if nb_seq else 0.0,
            "seq_size_deviation": round(
                max(seq_sumsq[0] / nb_seq
                    - (seq_total_size / nb_seq) ** 2, 0.0) ** 0.5, 1)
            if nb_seq else 0.0,
            "kmer_size": k,
            "abundance_min": amin,
            "abundance_max": amax,
            "time_fill": t_fill,
            "time_merge": t_merge,
            # distinct device programs compiled by THIS run (shape
            # discipline metric — every new shape is a fresh compile)
            "nb_device_programs": self._program_cache_size() - programs0,
            # passes actually RUN (>= cfg.nb_passes after optimistic
            # re-planning, counting._RePlan)
            "nb_passes_effective": int(nb_passes),
        }
        # reference-style per-phase tree (fill_partitions/fill_solid_kmers
        # + phase breakdown, PartitionsCommand.cpp:1229-1235): here 'fill'
        # = host parse/stack, 'solid' = device sort/reduce/merge
        phases = ti.get_properties("fillsolid_time")
        info.update(phases)
        info["time.fill_partitions"] = round(
            t_fill - ti.entries.get("2.sort", 0.0), 3)
        info["time.fill_solid_kmers"] = round(
            ti.entries.get("2.sort", 0.0) + t_merge, 3)
        self.info.update(info)  # Algorithm.get_info() surface
        return CountResult(solid_kmers, solid_counts, histogram, info,
                           cfg)


_SYNC_UB_ROWS = 1 << 24


def _merge_smallest_pair(lst) -> None:
    """Merge the two smallest device tables of `lst` in place (one
    bitonic merge level + reduce, ops/sortops.merge_tables_planes) —
    the rolling-merge step that bounds HBM during a pass.

    Entries are (planes, counts, n, ub): n may be a DEVICE scalar (no
    host sync on the merge path — each int(n) fetch is a device round
    trip); ub is a host-known upper bound that sizes merge
    capacities. ua+ub gives high-overlap merges NO dedup credit, so a
    pass's chained merges would grow caps toward the pass's TOTAL rows
    (the r4 stress cold run OOM'd HBM at a 2^29-row merge this way);
    once the bound crosses _SYNC_UB_ROWS the exact n is fetched (one
    round trip, negligible at that scale) and becomes the bound.
    Rows past n are all-ones sentinels (the compaction pads with them),
    so chained merges mask them without trimming."""
    from ..ops.sortops import merge_tables_planes

    # LAZY bound refresh (r4): entries whose soft bound crossed the sync
    # threshold fetch their exact n NOW — their producing dispatch is
    # typically superbatches old, so the device_get no longer stalls the
    # pipeline (an eager output-time sync serializes the whole merge
    # chain)
    for i, t in enumerate(lst):
        if t[3] >= _SYNC_UB_ROWS:
            lst[i] = (t[0], t[1], t[2], int(jax.device_get(t[2])))
    lst.sort(key=lambda t: t[3])
    (pa, ca, na, ua), (pb, cb, nb, ub) = lst[0], lst[1]
    cap_out = _next_pow2(max(ua + ub, 256))
    planes, counts, n, _ = merge_tables_planes(
        pa, jnp.asarray(ca), _as_i32(na),
        pb, jnp.asarray(cb), _as_i32(nb), cap_out=cap_out)
    del lst[:2]
    lst.append((planes, counts, n, ua + ub))


def _as_i32(n):
    return jnp.int32(n) if isinstance(n, int) else n


def _merge_table_list(tables, w: int):
    """Merge a list of (planes, counts, n, ub) distinct tables into final
    host (kmers (N, W), counts (N,)) arrays — sync-free merges (device n
    scalars, ub-sized capacities), ONE n fetch, one packed table fetch."""
    tables = [t for t in tables if t[3] > 0]
    if not tables:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    while len(tables) > 1:
        _merge_smallest_pair(tables)
    planes, counts, n, _ = tables[0]
    return _fetch_table(planes, counts, int(n), w)


@functools.partial(jax.jit, static_argnames=("cap_out", "max_exc"))
def _pack_table_jit(planes, counts, n, cap_out=None, max_exc=4096):
    """Pack a distinct table for the host fetch: planes stacked into ONE
    (W, cap_out)
    array (in-jit trim — capacities can exceed pow2(n) on the sync-free
    merge path), counts clamped to uint8, and the rare counts >= 255 as
    an exception list — one round trip, 9/12 of the int32 bytes."""
    cap = counts.shape[0]
    if cap_out is None or cap_out > cap:
        cap_out = cap
    idx = jax.lax.broadcasted_iota(jnp.int32, (cap_out,), 0)
    counts = counts[:cap_out]
    valid = idx < n
    c8 = jnp.where(valid, jnp.minimum(counts, 254), 0).astype(jnp.uint8)
    is_exc = (counts >= 255) & valid
    n_exc = jnp.sum(is_exc.astype(jnp.int32))
    exc_pos = jnp.sort(jnp.where(is_exc, idx, jnp.int32(MAX_INT32)))
    exc_pos = exc_pos[:max_exc]
    exc_val = counts[jnp.minimum(exc_pos, cap_out - 1)]
    return (jnp.stack([p[:cap_out] for p in planes]), c8, n_exc,
            exc_pos, exc_val)


def _fetch_table(planes, counts, n, w):
    """ONE host fetch of a device distinct table -> (kmers (n, W) uint32,
    counts (n,) int32). Counts ride as uint8 + an exception list; if the
    exception capacity overflows (pathological distribution) fall back to
    the exact int32 fetch."""
    if n == 0:
        return np.zeros((0, w), np.uint32), np.zeros((0,), np.int32)
    packed = _pack_table_jit(tuple(planes), counts, jnp.int32(n),
                             cap_out=_next_pow2(max(n, 256)))
    stacked, c8, n_exc, exc_pos, exc_val = jax.device_get(packed)
    ne = int(n_exc)
    if ne > exc_pos.shape[0]:
        uniq = np.stack([np.asarray(p[:n]) for p in planes], axis=1)
        return uniq, np.asarray(counts[:n]).astype(np.int32)
    cnt = c8.astype(np.int32)
    if ne:
        cnt[exc_pos[:ne]] = exc_val[:ne]
    return np.ascontiguousarray(stacked[:, :n].T), cnt[:n]


@functools.partial(jax.jit, static_argnames=("chunk", "max_exc"))
def _pack_table_chunk_jit(planes, counts, start, n, chunk: int,
                          max_exc: int = 4096):
    """Chunked variant of _pack_table_jit: pack rows [start, start+chunk)
    of a device distinct table for the host fetch. ``start`` is traced
    (one compiled program per (capacity, chunk) pair regardless of the
    number of chunks); chunk-aligned starts never clamp because the
    capacity is a pow2 multiple of the pow2 chunk."""
    sl = lambda x: jax.lax.dynamic_slice(x, (start,), (chunk,))
    idx = jax.lax.broadcasted_iota(jnp.int32, (chunk,), 0)
    c = sl(counts)
    valid = (idx + start) < n
    c8 = jnp.where(valid, jnp.minimum(c, 254), 0).astype(jnp.uint8)
    is_exc = (c >= 255) & valid
    n_exc = jnp.sum(is_exc.astype(jnp.int32))
    exc_pos = jnp.sort(jnp.where(is_exc, idx, jnp.int32(MAX_INT32)))
    exc_pos = exc_pos[:max_exc]
    exc_val = c[jnp.minimum(exc_pos, chunk - 1)]
    return (jnp.stack([sl(p) for p in planes]), c8, n_exc, exc_pos,
            exc_val)


class _StreamedTable:
    """Per-pass distinct table streamed from device to host in chunks.

    The pack dispatches are issued up front (async); a background thread
    pulls each chunk over the link while the consumer (the
    CountProcessor sweep) processes earlier chunks — overlapping the
    device->host fetch with host compute. Chunks are cached host-side so
    repeated iteration (the auto-cutoff double sweep) is free, and the
    device references are dropped once the fetch completes."""

    def __init__(self, planes, counts, n: int, w: int,
                 chunk_rows: int = 1 << 23):
        import threading

        self.n = int(n)
        self.w = w
        self._chunks: list = []
        self._err: BaseException | None = None
        self._done = self.n == 0
        self._cond = threading.Condition()
        if self._done:
            return
        cap = counts.shape[0]
        chunk = min(_next_pow2(max(chunk_rows, 256)), cap)
        starts = list(range(0, self.n, chunk))
        packs = [_pack_table_chunk_jit(tuple(planes), counts,
                                       jnp.int32(s), jnp.int32(self.n),
                                       chunk=chunk) for s in starts]

        def pull():
            try:
                for s, pk in zip(starts, packs):
                    rows = min(self.n - s, chunk)
                    stacked, c8, n_exc, exc_pos, exc_val = \
                        jax.device_get(pk)
                    ne = int(n_exc)
                    if ne > exc_pos.shape[0]:
                        # pathological count distribution: exact fetch
                        uk = np.stack(
                            [np.asarray(p[s:s + rows]) for p in planes],
                            axis=1)
                        uc = np.asarray(counts[s:s + rows]).astype(
                            np.int32)
                    else:
                        cnt = c8.astype(np.int32)
                        if ne:
                            cnt[exc_pos[:ne]] = exc_val[:ne]
                        uk = np.ascontiguousarray(stacked[:, :rows].T)
                        uc = cnt[:rows]
                    with self._cond:
                        self._chunks.append((uk, uc))
                        self._cond.notify_all()
            except BaseException as e:
                with self._cond:
                    self._err = e
                    self._cond.notify_all()
            finally:
                with self._cond:
                    self._done = True
                    self._cond.notify_all()

        self._thread = threading.Thread(target=pull, daemon=True)
        self._thread.start()

    def iter(self):
        i = 0
        while True:
            with self._cond:
                while (i >= len(self._chunks) and not self._done
                       and self._err is None):
                    self._cond.wait()
                if self._err is not None:
                    raise self._err
                if i < len(self._chunks):
                    chunk = self._chunks[i]
                else:
                    return
            yield chunk
            i += 1

    def materialize(self):
        """Concatenated (kmers, counts) host arrays (tests/back-compat)."""
        ks, cs = [], []
        for uk, uc in self.iter():
            ks.append(uk)
            cs.append(uc)
        if not ks:
            return (np.zeros((0, self.w), np.uint32),
                    np.zeros((0,), np.int32))
        return np.concatenate(ks), np.concatenate(cs)


class _MaterialTable:
    """Already-fetched (kmers, counts) host table with the same .iter()
    surface as _StreamedTable (LSM fallback path)."""

    def __init__(self, kmers: np.ndarray, counts: np.ndarray):
        self._kmers, self._counts = kmers, counts
        self.n = len(counts)
        self.w = kmers.shape[1] if kmers.ndim == 2 else 0

    def iter(self):
        if self.n:
            yield self._kmers, self._counts

    def materialize(self):
        return self._kmers, self._counts


def _global_merge(kmers: np.ndarray, counts: np.ndarray, w: int):
    """Device sort+reduce of concatenated partial tables -> final table."""
    n = len(kmers)
    if n == 0:
        return kmers, counts
    cap = _next_pow2(max(n, 8))
    pk = np.full((cap, w), 0xFFFFFFFF, np.uint32)
    pc = np.zeros((cap,), np.int32)
    pk[:n] = kmers
    pc[:n] = counts
    inv = np.ones((cap,), bool)
    inv[:n] = False
    table = _merge_jit(jnp.asarray(pk), jnp.asarray(pc), jnp.asarray(inv))
    m = int(table.n)
    return np.asarray(table.kmers[:m]), np.asarray(table.counts[:m])


@jax.jit
def _merge_jit(kmers, counts, inv) -> CountTable:
    sk, si, sc = sort_by_kmer(kmers, inv, counts)
    return count_sorted(sk, si, weights=sc)


def count_kmers(bank, processor=None, **kwargs) -> CountResult:
    """Convenience API: count kmers of a bank (URI, IBank, or list).

    ``processor``: optional custom CountProcessor joining the run's
    processor vector (see SortingCount)."""
    return SortingCount(CountConfig(**kwargs),
                        processor=processor).execute(bank)


# ---------------------------------------------------------------------------
# Multi-bank counting + solidity kinds
# ---------------------------------------------------------------------------


@dataclass
class MultiBankCountResult:
    """Multi-bank counting output (reference _multibank variants,
    PartitionsCommand.cpp:1855-2100).

    kmers: (N, W) sorted distinct kmers across all banks
    counts_per_bank: (N, B) int32 per-bank abundances
    counts_sum: (N,) total abundances
    solid_mask: (N,) solidity by the configured kind
    """

    kmers: np.ndarray
    counts_per_bank: np.ndarray
    counts_sum: np.ndarray
    solid_mask: np.ndarray
    info: dict

    @property
    def solid_kmers(self) -> np.ndarray:
        return self.kmers[self.solid_mask]

    @property
    def solid_counts(self) -> np.ndarray:
        return self.counts_sum[self.solid_mask]


def solidity_check(counts: np.ndarray, kind: str, thresholds,
                   solid_vec=None) -> np.ndarray:
    """Vectorized port of the CountProcessorSolidity checks
    (kmer/impl/CountProcessorSolidity.hpp:177-311).

    counts: (N, B) per-bank abundances; thresholds: list of (min, max)
    per bank (a single pair is broadcast); solid_vec: presence pattern
    for kind='custom'.
    """
    counts = np.asarray(counts)
    n, b = counts.shape
    if isinstance(thresholds, tuple):
        thresholds = [thresholds]
    if len(thresholds) == 1:
        thresholds = thresholds * b
    lo = np.asarray([t[0] for t in thresholds])
    hi = np.asarray([t[1] for t in thresholds])
    in_range = (counts >= lo[None, :]) & (counts <= hi[None, :])
    total = counts.sum(axis=1)
    if kind == "sum":
        return (total >= thresholds[0][0]) & (total <= thresholds[0][1])
    if kind == "max":
        m = counts.max(axis=1)
        return (m >= thresholds[0][0]) & (m <= thresholds[0][1])
    if kind == "min":
        m = counts.min(axis=1)
        return (m >= thresholds[0][0]) & (m <= thresholds[0][1])
    if kind == "all":
        return in_range.all(axis=1)
    if kind == "one":
        return in_range.any(axis=1)
    if kind == "custom":
        if solid_vec is None:
            raise ValueError("custom solidity needs solid_vec")
        sv = np.asarray(solid_vec, bool)
        return (in_range == sv[None, :]).all(axis=1)
    raise ValueError(f"unknown solidity kind {kind!r}")


@functools.partial(jax.jit,
                   static_argnames=("k", "m", "spare", "nb_banks",
                                    "cap_out", "nb_passes"))
def _superbatch_count_multibank(codes, valid, lengths, bank_ids, pass_i, *,
                                k: int, m: int, spare: bool, nb_banks: int,
                                cap_out: int | None = None,
                                nb_passes: int = 1):
    """Multibank superbatch: ONE sort over the union of all banks' kmers
    with the bank id riding as payload; the reduce yields per-bank count
    columns (reference one-pass multibank matrices,
    PartitionsCommand.cpp:1855-2100). bank_ids: (G, B) per-read bank.
    nb_passes > 1 applies the DSK pass filter
    (minimizer % nb_passes == pass, SortingCountAlgorithm.cpp:806)."""
    from ..ops.sortops import count_planes_multibank, _next_pow2

    w = nb_limbs(k)

    def ext(args):
        c, v, l, bid = args
        kb = extract_kmers(c, v, l, k, m, with_minimizers=nb_passes > 1)
        pv = kb.valid
        if nb_passes > 1:
            pv = pv & (kb.minimizer % jnp.uint32(nb_passes)
                       == pass_i.astype(jnp.uint32))
        planes = tuple(kb.kmers[..., j].reshape(-1) for j in range(w))
        kbank = jnp.broadcast_to(bid[:, None], kb.valid.shape).reshape(-1)
        return planes, pv.reshape(-1), kbank

    planes, pv, pbank = jax.lax.map(ext, (codes, valid, lengths, bank_ids))
    flat = tuple(p.reshape(-1) for p in planes)
    fv = pv.reshape(-1)
    fb = pbank.reshape(-1)
    n_rows = flat[0].shape[0]
    cap = _next_pow2(max(n_rows, 256))
    pad = cap - n_rows
    if pad:
        flat = tuple(jnp.concatenate(
            [p, jnp.full((pad,), jnp.uint32(0xFFFFFFFF))]) for p in flat)
        fv = jnp.concatenate([fv, jnp.zeros((pad,), bool)])
        fb = jnp.concatenate([fb, jnp.zeros((pad,), fb.dtype)])
    return count_planes_multibank(flat, fv, fb, nb_banks, spare_bits=spare,
                                  cap_out=cap_out)


def count_kmers_multibank(banks, kmer_size: int = 31,
                          abundance_min=2, abundance_max=MAX_INT32,
                          solidity_kind: str = "sum", solid_vec=None,
                          batch_reads: int = 1024, batch_len: int = 256,
                          superbatch_rows: int = 1 << 22,
                          minimizer_size: int = 10, nb_passes: int = 1,
                          processor=None,
                          **kwargs) -> MultiBankCountResult:
    """One-pass multibank counting: all banks stream through ONE counting
    pipeline with per-bank count columns riding the sort (reference
    _multibank variants, PartitionsCommand.cpp:1855-2100 — NOT B
    independent passes). ``abundance_min``/``abundance_max`` may be scalars
    or per-bank lists (reference custom thresholds). ``nb_passes`` bounds
    live device memory exactly like the single-bank DSK pass loop."""
    from ..bank.fasta import open_bank
    from ..ops.sortops import merge_tables_planes_multi, _next_pow2

    banks = [open_bank(b) for b in banks]
    nb = len(banks)
    k = kmer_size
    w = nb_limbs(kmer_size)
    spare = (2 * k) % 32 != 0
    nb_passes = max(1, int(nb_passes))
    builder = _BatchBuilder(k, batch_reads, batch_len)
    rows_per_batch = batch_reads * (builder.L - k + 1)
    G = max(1, int(superbatch_rows) // rows_per_batch)

    def produce():
        """(batch, bank_id) stream; the builder is flushed at bank
        boundaries so every batch belongs to one bank."""
        for j, bk in enumerate(banks):
            for seq in bk:
                for batch in builder.add(seq.data):
                    yield batch, j
            if builder.row:
                yield builder.flush(), j

    tables: list = []  # (planes, counts_tuple, n)
    # adaptive distinct-ratio capacity, learned per superbatch exactly
    # like the single-bank driver (overflow flag guards exactness)
    dedup_ratio = {"est": 0.25}

    def flush_group(group, pass_i):
        g = len(group)
        if g < G:
            gp = _next_pow2(g)
            B, L = group[0][0][0].shape
            while len(group) < gp:
                group.append(((np.zeros((B, L), np.uint8),
                               np.zeros((B, L), bool),
                               np.zeros((B,), np.int32), 0), 0))
        codes = jnp.asarray(np.stack([b[0][0] for b in group]))
        valid = jnp.asarray(np.stack([b[0][1] for b in group]))
        lengths = jnp.asarray(np.stack([b[0][2] for b in group]))
        bank_ids = jnp.asarray(np.stack(
            [np.full((group[0][0][0].shape[0],), b[1], np.uint32)
             for b in group]))
        rows = _next_pow2(max(codes.shape[0] * rows_per_batch, 256))
        cap_out = _next_pow2(max(
            256, min(rows, int(rows * dedup_ratio["est"] * 1.5))))
        out = _superbatch_count_multibank(
            codes, valid, lengths, bank_ids, jnp.int32(pass_i), k=k,
            m=minimizer_size, spare=spare, nb_banks=nb, cap_out=cap_out,
            nb_passes=nb_passes)
        if bool(out[3]):
            out = _superbatch_count_multibank(
                codes, valid, lengths, bank_ids, jnp.int32(pass_i), k=k,
                m=minimizer_size, spare=spare, nb_banks=nb, cap_out=None,
                nb_passes=nb_passes)
        out_p, counts_t, n, _ = out
        n = int(n)
        dedup_ratio["est"] = max(dedup_ratio["est"], n / rows)
        capn = _next_pow2(max(n, 256))
        tables.append((tuple(p[:capn] for p in out_p),
                       tuple(c[:capn] for c in counts_t), n))

    for pass_i in range(nb_passes):
        group: list = []
        for item in _prefetch(produce(), depth=4):
            group.append(item)
            if len(group) == G:
                flush_group(group, pass_i)
                group = []
        if group:
            flush_group(group, pass_i)

    # pairwise merge (smallest first), count columns riding each merge
    tables = [t for t in tables if t[2] > 0]
    while len(tables) > 1:
        tables.sort(key=lambda t: t[2])
        (pa, ca, na), (pb, cb, nbl) = tables[0], tables[1]
        cap_out = _next_pow2(max(na + nbl, 256))
        planes, counts_t, n, _ = merge_tables_planes_multi(
            pa, ca, jnp.int32(na), pb, cb, jnp.int32(nbl), cap_out=cap_out)
        tables = tables[2:] + [(planes, counts_t, int(n))]

    if tables:
        planes, counts_t, n = tables[0]
        uniq = np.stack([np.asarray(p)[:n] for p in planes], axis=1) \
            if n else np.zeros((0, w), np.uint32)
        counts = np.stack([np.asarray(c)[:n] for c in counts_t], axis=1) \
            if n else np.zeros((0, nb), np.int32)
    else:
        uniq = np.zeros((0, w), np.uint32)
        counts = np.zeros((0, nb), np.int32)

    amin = abundance_min if isinstance(abundance_min, (list, tuple)) \
        else [abundance_min]
    amax = abundance_max if isinstance(abundance_max, (list, tuple)) \
        else [abundance_max]
    if len(amin) == 1:
        amin = amin * nb
    if len(amax) == 1:
        amax = amax * nb
    thresholds = list(zip(amin, amax))
    solid = solidity_check(counts, solidity_kind, thresholds, solid_vec)

    if processor is not None:
        # custom CountProcessor sweep over the kmer-complete matrix
        # (ICountProcessor.hpp:92-200 lifecycle; per-bank counts like the
        # reference _multibank PartitionsCommands feed their processor)
        processor.begin(None)
        processor.begin_pass(0)
        clone = processor.clone()
        clone.begin_part(0, 0, 0, "multibank")
        clone.process_table(0, uniq, counts,
                            counts.sum(axis=1).astype(np.int64))
        clone.end_part(0, 0)
        processor.end_pass(0)
        processor.finish_clones([clone])
        processor.end()

    total = counts.sum(axis=1).astype(np.int64)
    info = {
        "kmers_nb_distinct": int(len(uniq)),
        "kmers_nb_solid": int(solid.sum()),
        "solidity_kind": solidity_kind,
        "nb_banks": nb,
    }
    return MultiBankCountResult(uniq, counts, total, solid, info)


def _rows_searchsorted(table: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Index of each query row in a row-sorted uint32 array (exact match)."""
    def pack(a):
        return np.ascontiguousarray(a).view(
            [("", a.dtype)] * a.shape[1]).ravel()

    t = pack(table)
    q = pack(queries)
    idx = np.searchsorted(t, q)
    return idx
