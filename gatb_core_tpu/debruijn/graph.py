"""De Bruijn graph over the solid k-mer set (GraphTemplate equivalent).

Reference: debruijn/impl/Graph.hpp:540 / Graph.cpp. The reference's node
membership is (Bloom AND not-cFP), which by construction of the cFP set
equals exact membership in the solid set for every query on the traversal
path (neighbors of contained nodes). Here membership is exact by design —
a device binary search over the sorted solid table (collections/sortedset),
with an optional Bloom front for batched prefiltering — so graph topology is
identical to the reference's for the same solid set.

Node identity: canonical kmer value, represented as (W,) uint32 big-endian
limbs. Node index (nodeMPHFIndex, Graph.hpp:924) = rank in the sorted solid
table. Per-node arrays (abundance, state, adjacency) are indexed by it.

The build is the reference's state machine (Graph.cpp build_visitor_solid +
build_visitor_postsolid): configuration -> counting -> [bloom] -> branching,
persisted stage-by-stage into HDF5 storage for checkpoint/resume
(Graph.hpp:1010-1030 state bits).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import jax
import jax.numpy as jnp

from ..collections.sortedset import SortedKmerSet
from ..collections.abundance import discretize, dediscretize
from ..kmer.counting import CountConfig, SortingCount, CountResult
from ..kmer.model import string_to_kmer, kmer_to_string, canonical
from ..ops.kmer_ops import nb_limbs, py_to_limbs, kmers_to_py
from ..ops.neighbor_ops import neighbor_candidates
from ..storage import hdf5 as storage_mod
from ..storage.filedir import open_storage
from ..storage.hdf5 import (
    Storage, STATE_SORTING_COUNT_DONE, STATE_BRANCHING_DONE,
    STATE_ADJACENCY_DONE, STATE_BLOOM_DONE, STATE_DEBLOOM_DONE,
    STATE_MPHF_DONE,
)

U32 = jnp.uint32


@functools.partial(jax.jit, static_argnames=("k",))
def _adjacency_kernel(nodes, table, k: int, n_table=None):
    """8-bit adjacency masks for a batch of nodes against the solid table.

    Membership via the sort-join (ops/sortops.rank_join): the reference's
    per-neighbor hash probes (Graph.cpp:3508-3610) would be log(n) random
    gathers per candidate here — the gather wall (BASELINE.md).
    ``n_table`` is TRACED (r4): with a pow2-padded table every capacity
    bucket compiles once, however the live count drifts between
    simplify compaction passes."""
    from ..ops.sortops import rank_join_traced

    n, w = nodes.shape
    if n_table is None:
        n_table = table.shape[0]
    cands = neighbor_candidates(nodes, k)      # (N, 8, W)
    flat = cands.reshape(n * 8, w)
    _, found = rank_join_traced(table, flat, n_table)
    bits = found.reshape(n, 8).astype(jnp.uint8)
    weights = (jnp.uint8(1) << jnp.arange(8, dtype=jnp.uint8))
    return jnp.sum(bits * weights[None, :], axis=1, dtype=jnp.uint8)


class Graph:
    """Node-centric de Bruijn graph (batched, device-resident queries)."""

    def __init__(self, kmer_size: int, solid_limbs: np.ndarray,
                 solid_counts: np.ndarray, storage: Storage | None = None,
                 info: dict | None = None, mesh=None):
        self.kmer_size = kmer_size
        #: optional jax.sharding.Mesh — postsolid stages (adjacency,
        #: debloom, unitig construction) run range-sharded over it
        #: (parallel/postsolid.py); None = single-device kernels
        self.mesh = mesh
        self._k = kmer_size
        self._w = nb_limbs(kmer_size)
        self.solid_limbs = np.asarray(solid_limbs, np.uint32)
        self.solid_counts = np.asarray(solid_counts, np.int32)
        self._set = SortedKmerSet(jnp.asarray(self.solid_limbs),
                                  len(self.solid_limbs))
        self.storage = storage
        self.info = dict(info or {})
        n = len(self.solid_limbs)
        # per-node maps (MPHF-indexed): abundance (8-bit discretized),
        # state byte (bit0: deleted, bits1+: user marks), adjacency cache
        self.abundance_codes = discretize(self.solid_counts)
        self.node_state = np.zeros(n, np.uint8)
        self._adjacency: np.ndarray | None = None
        self._branching: np.ndarray | None = None
        self._mphf = None  # optional BooPHF accelerator (build_mphf)
        self._debloom = None          # DebloomResult (bloom + cFP)
        self._container = None        # BloomCfpContainer membership oracle
        self.membership_mode = "exact"  # or "bloom_cfp"

    # ------------------------------------------------------------------
    # creation / loading
    # ------------------------------------------------------------------
    @classmethod
    def create(cls, bank=None, kmer_size: int = 31, abundance_min=2,
               abundance_max=2**31 - 1, minimizer_size: int = 10,
               output: str | None = None, histo_max: int = 10000,
               batch_reads: int = 1024, batch_len: int = 256,
               build_branching: bool = True, nb_passes: int = 1,
               bloom_kind: str = "neighbor", debloom_kind: str = "cascading",
               mphf_kind: str = "boophf",
               repartition: bool = True,
               superbatch_rows: int | None = None, mesh=None,
               table_budget_bytes: int | None = None) -> "Graph":
        """Full graph build from a bank (Graph::create equivalent):
        config -> repartitor -> DSK (build_visitor_solid, Graph.cpp:286-433)
        then MPHF -> Bloom -> Debloom -> Branching (build_visitor_postsolid,
        Graph.cpp:433-605), each stage persisted + state-bit-stamped.
        Kind defaults mirror the reference enums (misc/api/Enums.hpp:73-271:
        BloomKind=cache, DebloomKind=cascading); 'none' skips a stage."""
        cfg = CountConfig(kmer_size=kmer_size, abundance_min=abundance_min,
                          abundance_max=abundance_max,
                          minimizer_size=minimizer_size, histo_max=histo_max,
                          batch_reads=batch_reads, batch_len=batch_len,
                          nb_passes=nb_passes)
        if superbatch_rows is not None:
            cfg.superbatch_rows = superbatch_rows
        if table_budget_bytes is not None:
            cfg.table_budget_bytes = table_budget_bytes
        # RepartitorAlgorithm (Graph.cpp:384) -> /minimizers: the census
        # is host-only numpy over a bank sample, so it runs on a
        # background thread CONCURRENTLY with the device counting below
        # (r5: ~3 s of the stress dbgh5 wall-clock for free)
        rep_thread = rep_box = None
        if output is not None and repartition:
            import threading

            from ..kmer.repartition import build_repartitor

            rep_box = [None, None]

            def _rep():
                try:
                    nb_parts = max(1, _plan_partitions(
                        bank, kmer_size, minimizer_size))
                    rep_box[0] = build_repartitor(bank, kmer_size,
                                                  nb_parts,
                                                  minimizer_size)
                except BaseException as e:
                    rep_box[1] = e

            rep_thread = threading.Thread(target=_rep, daemon=True)
            rep_thread.start()

        # Algorithm contract: run() wraps execute() with exec_time + the
        # stopwatch tree (executeAlgorithm, Graph.cpp:242-262)
        dsk = SortingCount(cfg)
        result = dsk.run(bank)
        result.info.update({k: v for k, v in dsk.get_info().items()
                            if k == "exec_time"})

        storage = None
        if output is not None:
            storage = open_storage(output, "w")
            storage_mod.save_config(storage, result.info)
            storage_mod.save_solid(storage, result.solid_kmers,
                                   result.solid_counts, kmer_size)
            storage_mod.save_histogram(storage, result.histogram)
            if rep_thread is not None:
                rep_thread.join()
                if rep_box[1] is not None:
                    raise rep_box[1]
                rep_box[0].save(storage)

        graph = cls(kmer_size, result.solid_kmers, result.solid_counts,
                    storage, result.info, mesh=mesh)
        graph.build_postsolid(bloom_kind=bloom_kind,
                              debloom_kind=debloom_kind,
                              mphf_kind=mphf_kind,
                              build_branching=build_branching)
        if storage is not None:
            storage.flush()
        return graph

    def build_postsolid(self, bloom_kind: str = "neighbor",
                        debloom_kind: str = "cascading",
                        mphf_kind: str = "boophf",
                        build_branching: bool = True) -> None:
        """build_visitor_postsolid (Graph.cpp:433-605): MPHF -> Bloom ->
        Debloom -> Branching, persisting each stage. Per-stage wall
        times land in `info` as reference-style `time.` properties
        (the getInfo 'time' tree each Algorithm emits —
        Algorithm.cpp:56-62 pattern), so postsolid perf work has a
        stage breakdown (VERDICT r2 weak #10)."""
        from ..misc.time_info import TimeInfo

        ti = TimeInfo()
        if mphf_kind != "none":
            with ti.section("mphf"):
                self.build_mphf()  # MPHFAlgorithm (Graph.cpp:488-498)
                if self.storage is not None:
                    storage_mod.save_mphf(self.storage, self._mphf,
                                          self.abundance_codes,
                                          solid_limbs=self.solid_limbs,
                                          kmer_size=self._k)
        if bloom_kind != "none" and debloom_kind != "none":
            # BloomAlgorithm + DebloomAlgorithm (Graph.cpp:517-556)
            from ..kmer.debloom import build_debloom, BloomCfpContainer

            with ti.section("debloom"):
                deb = build_debloom(self.solid_limbs, self._k,
                                    cascading=debloom_kind == "cascading",
                                    bloom_kind=bloom_kind, mesh=self.mesh)
                self._debloom = deb
                self._container = BloomCfpContainer(deb)
                self.info.update(deb.info)
                if self.storage is not None:
                    storage_mod.save_bloom(self.storage, deb.bloom)
                    storage_mod.save_debloom(self.storage, deb.cfp,
                                             self._k, kind=deb.kind,
                                             cascade=deb.cascade)
        if build_branching:
            with ti.section("branching"):
                # BranchingAlgorithm (Graph.cpp:572-582)
                self.branching_nodes()
        self.info.update(ti.get_properties("postsolid_time"))

    @classmethod
    def load(cls, uri: str) -> "Graph":
        """Reopen a persisted graph; resumes after completed stages
        (configure_visitor equivalent, Graph.cpp:766-802)."""
        storage = open_storage(uri, "a")
        if not storage.check_state(STATE_SORTING_COUNT_DONE):
            raise ValueError(f"{uri}: no completed counting stage")
        limbs, counts = storage_mod.load_solid(storage)
        k = storage_mod.prop_int(storage, "kmer_size")
        graph = cls(k, limbs, counts, storage)
        if storage.check_state(STATE_BRANCHING_DONE):
            rec = storage.group("branching").get_dataset("nodes")
            if rec is not None:
                graph._branching = storage_mod.words64_to_limbs(
                    rec["value"], graph._w)
                # counts ride in the same record (dbgcheck reads them;
                # r5 bug: loaded graphs lacked _branching_counts)
                graph._branching_counts = \
                    rec["abundance"].astype(np.int32)
        if storage.check_state(STATE_ADJACENCY_DONE):
            adj = storage.group("adjacency").get_dataset("masks")
            if adj is not None:
                graph._adjacency = adj
        if storage.check_state(STATE_MPHF_DONE):
            mphf, abund = storage_mod.load_mphf(storage, limbs, k)
            if mphf is not None:
                graph._mphf = mphf
                if abund is not None:
                    graph.abundance_codes = abund
        if storage.check_state(STATE_BLOOM_DONE) \
                and storage.check_state(STATE_DEBLOOM_DONE):
            bloom = storage_mod.load_bloom(storage)
            cfp = storage_mod.load_debloom(storage, graph._w)
            if bloom is not None and cfp is not None:
                from ..kmer.debloom import (DebloomResult, CascadeCFP,
                                            BloomCfpContainer)

                g = storage.group("debloom")
                kind = storage_mod.prop_str(g, "kind", "original")
                cascade = None
                if kind == "cascading" and "cascading" in g:
                    cg = g.group("cascading")
                    blooms = [storage_mod.load_bloom_group(
                        cg.group(f"bloom{i}")) for i in (2, 3, 4)]
                    t4 = cg.get_dataset("t4")
                    t4 = storage_mod.words64_to_limbs(t4, graph._w) \
                        if t4 is not None and len(t4) else \
                        np.zeros((0, graph._w), np.uint32)
                    cascade = CascadeCFP(blooms, t4)
                elif kind == "cascading" and "bloom2" in g:
                    # reference dbgh5 layout: /debloom/bloom{2,3,4} raw
                    # datasets with string attrs; cfp dataset holds T4
                    blooms = [storage_mod.load_bloom_dataset(
                        g._g[f"bloom{i}"]) for i in (2, 3, 4)]
                    cascade = CascadeCFP(blooms, cfp)
                deb = DebloomResult(bloom, cfp, len(cfp), {}, kind, cascade)
                graph._debloom = deb
                graph._container = BloomCfpContainer(deb)
        return graph

    # ------------------------------------------------------------------
    # basic accessors
    # ------------------------------------------------------------------
    @property
    def nb_nodes(self) -> int:
        return len(self.solid_limbs)

    def iter_nodes(self, chunk: int = 1 << 16):
        """Yield (limbs_chunk, counts_chunk) over all nodes in sorted order."""
        for i in range(0, self.nb_nodes, chunk):
            yield self.solid_limbs[i:i + chunk], \
                self.solid_counts[i:i + chunk]

    def build_node(self, seq: str) -> np.ndarray:
        """Node from a kmer string (Graph::buildNode): canonical limbs (W,)."""
        if len(seq) != self._k:
            raise ValueError(f"need a {self._k}-mer, got {len(seq)}")
        v = canonical(string_to_kmer(seq), self._k)
        return py_to_limbs([v], self._k)[0]

    def node_to_string(self, node: np.ndarray) -> str:
        return kmer_to_string(kmers_to_py(np.asarray(node)[None])[0], self._k)

    # ------------------------------------------------------------------
    # membership / index / abundance (batched)
    # ------------------------------------------------------------------
    def _as_batch(self, nodes) -> np.ndarray:
        nodes = np.asarray(nodes, np.uint32)
        if nodes.ndim == 1:
            nodes = nodes[None]
        return nodes

    def contains(self, nodes, mode: str | None = None) -> np.ndarray:
        """(N, W) or (W,) -> bool array.

        mode 'exact' (default): binary search in the sorted solid table.
        mode 'bloom_cfp': the reference's Bloom AND NOT cFP oracle
        (ContainerNode.hpp:60-90 / :109-190 cascading) — exact for every
        query in the 1-neighborhood of solid kmers, i.e. the closure
        traversal operates in; requires a completed debloom stage."""
        batch = self._as_batch(nodes)
        mode = mode or self.membership_mode
        if mode == "bloom_cfp":
            if self._container is None:
                raise ValueError("no debloom stage: bloom_cfp unavailable")
            return self._container.contains(batch)
        return np.asarray(self._set.contains(jnp.asarray(batch)))

    def set_membership_mode(self, mode: str) -> None:
        if mode not in ("exact", "bloom_cfp"):
            raise ValueError(f"unknown membership mode {mode!r}")
        if mode == "bloom_cfp" and self._container is None:
            raise ValueError("no debloom stage: bloom_cfp unavailable")
        self.membership_mode = mode

    def build_mphf(self) -> None:
        """Build the constant-time BooPHF node index (MPHFAlgorithm
        equivalent, kmer/impl/MPHFAlgorithm.cpp:150-330). Optional: without
        it node_index falls back to the O(log n) sorted-rank search; with it
        each query is O(levels) gathers. Codes are identical either way."""
        from ..collections.boophf import BooPHF

        self._mphf = BooPHF.build(jnp.asarray(self.solid_limbs),
                                  self.nb_nodes)

    def node_index(self, nodes) -> np.ndarray:
        """nodeMPHFIndex (Graph.hpp:924): rank in sorted table, -1 if absent."""
        batch = self._as_batch(nodes)
        if self._mphf is not None:
            idx = np.asarray(self._mphf.rank(jnp.asarray(batch)))
            safe = np.maximum(idx, 0)
            # MPHF contract: absent keys may alias a code — recheck the row
            ok = (idx >= 0) & (self.solid_limbs[safe] == batch).all(axis=-1)
            return np.where(ok, idx, -1)
        return np.asarray(self._set.rank(jnp.asarray(batch)))

    def query_abundance(self, nodes) -> np.ndarray:
        """Discretized abundance (queryAbundance, Graph.hpp:900)."""
        idx = self.node_index(nodes)
        out = dediscretize(self.abundance_codes[np.maximum(idx, 0)])
        return np.where(idx >= 0, out, 0)

    # ---- node state map (queryNodeState/setNodeState, Graph.hpp:904-913)
    def set_node_state(self, nodes, value: int) -> None:
        idx = self.node_index(nodes)
        self.node_state[idx[idx >= 0]] = np.uint8(value << 1) | \
            (self.node_state[idx[idx >= 0]] & 1)

    def query_node_state(self, nodes) -> np.ndarray:
        idx = self.node_index(nodes)
        return (self.node_state[np.maximum(idx, 0)] >> 1) * (idx >= 0)

    def delete_node(self, nodes) -> None:
        idx = self.node_index(nodes)
        self.node_state[idx[idx >= 0]] |= 1

    def delete_nodes_by_index(self, idx: np.ndarray) -> None:
        self.node_state[idx] |= 1

    def is_node_deleted(self, nodes) -> np.ndarray:
        idx = self.node_index(nodes)
        return (self.node_state[np.maximum(idx, 0)] & 1).astype(bool) \
            & (idx >= 0)

    # ------------------------------------------------------------------
    # adjacency / neighbors
    # ------------------------------------------------------------------
    def _padded_table(self):
        """Shared pow2-padded device copy of the solid table (one copy
        serves adjacency_masks AND precompute_adjacency — advisor r4:
        two padded copies doubled HBM on large graphs)."""
        if getattr(self, "_ptab", None) is None:
            from ..ops.sortops import pad_rows_pow2

            ptab, _ = pad_rows_pow2(self.solid_limbs)
            self._ptab = jnp.asarray(ptab)
        return self._ptab

    def adjacency_masks(self, nodes) -> np.ndarray:
        """8-bit neighbor mask per node: bits 0-3 out by nt, 4-7 in by nt."""
        batch = self._as_batch(nodes)
        return np.asarray(_adjacency_kernel(
            jnp.asarray(batch), self._padded_table(), self._k,
            self._set.n))

    def neighbors(self, node) -> dict:
        """Scalar convenience: {'out': [limbs...], 'in': [limbs...]}."""
        batch = self._as_batch(node)
        cands = np.asarray(neighbor_candidates(jnp.asarray(batch), self._k))
        mask = self.adjacency_masks(batch)[0]
        out = [cands[0, i] for i in range(4) if mask & (1 << i)]
        inn = [cands[0, 4 + i] for i in range(4) if mask & (1 << (4 + i))]
        return {"out": out, "in": inn}

    def out_degree(self, nodes) -> np.ndarray:
        m = self.adjacency_masks(nodes)
        return _popcount4(m & 0x0F)

    def in_degree(self, nodes) -> np.ndarray:
        m = self.adjacency_masks(nodes)
        return _popcount4(m >> 4)

    def precompute_adjacency(self, chunk: int | None = None) -> np.ndarray:
        """Cache the 8-bit mask for every node (precomputeAdjacency,
        Graph.cpp:3508-3610)."""
        if self._adjacency is None:
            import time as _t

            from ..ops.sortops import sweep_chunk

            t0 = _t.time()
            if self.mesh is not None and self.nb_nodes:
                from ..parallel.postsolid import distributed_adjacency

                self._adjacency = distributed_adjacency(
                    self.mesh, self.solid_limbs, self._k)
                self.info["postsolid_time.adjacency"] = round(
                    _t.time() - t0, 3)
                if self.storage is not None:
                    g = self.storage.group("adjacency")
                    g.set_dataset("masks", self._adjacency)
                    self.storage.set_state_bit(STATE_ADJACENCY_DONE)
                return self._adjacency
            masks = np.zeros(self.nb_nodes, np.uint8)
            n = self._set.n
            jtab = self._padded_table()
            pad_chunk = min(sweep_chunk(self.nb_nodes),
                            _next_pow2_int(max(1, self.nb_nodes)))
            if chunk:   # caller-imposed device-memory bound: round DOWN
                c = _next_pow2_int(chunk)
                pad_chunk = min(pad_chunk, max(c // 2, 1) if c > chunk
                                else c)
            for i in range(0, self.nb_nodes, pad_chunk):
                part = self.solid_limbs[i:i + pad_chunk]
                npart = len(part)
                if npart < pad_chunk:  # pad to static shape
                    pad = np.zeros((pad_chunk - npart, self._w),
                                   np.uint32)
                    part = np.concatenate([part, pad])
                masks[i:i + npart] = np.asarray(_adjacency_kernel(
                    jnp.asarray(part), jtab, self._k, n))[:npart]
            self._adjacency = masks
            # drop the padded device copy: the uint8 masks answer the
            # bulk queries from here on; scalar adjacency_masks calls
            # re-stage on demand (advisor r4 HBM finding)
            self._ptab = None
            self.info["postsolid_time.adjacency"] = round(_t.time() - t0, 3)
            if self.storage is not None:
                g = self.storage.group("adjacency")
                g.set_dataset("masks", masks)
                self.storage.set_state_bit(STATE_ADJACENCY_DONE)
        return self._adjacency

    # ------------------------------------------------------------------
    # branching (BranchingAlgorithm, debruijn/impl/BranchingAlgorithm.cpp)
    # ------------------------------------------------------------------
    def branching_nodes(self) -> np.ndarray:
        """Sorted branching nodes (indegree != 1 or outdegree != 1)."""
        if self._branching is None:
            adj = self.precompute_adjacency()
            outd = _popcount4(adj & 0x0F)
            ind = _popcount4(adj >> 4)
            mask = (outd != 1) | (ind != 1)
            self._branching = self.solid_limbs[mask]
            self._branching_counts = self.solid_counts[mask]
            if self.storage is not None:
                g = self.storage.group("branching")
                words = storage_mod.limbs_to_words64(self._branching)
                rec = np.zeros(len(self._branching),
                               dtype=storage_mod.count_dtype(words.shape[1]))
                rec["value"] = words
                rec["abundance"] = self._branching_counts
                g.set_dataset("nodes", rec)
                g.set_property("nb_branching", np.uint64(len(rec)))
                g.set_property("checksum_branching",
                               self.checksum_branching())
                self.storage.set_state_bit(STATE_BRANCHING_DONE)
        return self._branching

    def checksum_branching(self) -> str:
        """Sum of branching kmer values mod 2^(64*words), printed exactly
        like LargeInt::operator<< (LargeInt.hpp:630-648): 64-bit hex words
        high-to-low, '.'-separated, leading zero words skipped
        (BranchingAlgorithm.cpp:263-314)."""
        nodes = self.branching_nodes()
        words = max(1, (self._k + 31) // 32)
        total = 0
        vals = kmers_to_py(nodes)
        mod = 1 << (64 * words)
        for v in vals:
            total = (total + v) % mod
        ws = [(total >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
              for i in range(words)]
        i = words - 1
        while i >= 0 and ws[i] == 0:
            i -= 1
        if i < 0:
            return ""  # reference prints nothing for an all-zero value
        return ".".join(f"{ws[j]:x}" for j in range(i, -1, -1))

    def simplify(self, verbose: int = 0):
        """Run the full tip/bulge/EC simplification (Graph::simplify,
        Graph.hpp:796 / Simplifications.cpp:112-215)."""
        import time as _t

        from .simplifications import Simplifications

        t0 = _t.time()
        simp = Simplifications(self, verbose=verbose)
        stats = simp.simplify()
        # keep the instance: its full-table candidate sweep and final
        # compaction serve the Monument engine (assemble_contigs) with
        # zero re-sweeps (r5: the duplicate sweep was 11.4 of reads3's
        # 15.9 s Monument wall)
        self._simplifications = simp
        self.info["postsolid_time.simplify"] = round(_t.time() - t0, 3)
        return stats

    def contigs(self, min_contig_len: int | None = None,
                traversal: str = "simple"):
        """Batched contig construction — the scalable equivalent of
        looping gatb-core's Traversal over all unmarked nodes with a
        Terminator (the Minia assembly loop, Traversal.cpp:68-160).
        Run `simplify()` first for cleaned contigs.

        traversal='simple' (default): every maximal simple path of the
        LIVE graph, as one compaction over unitigs instead of per-kmer
        Python walks. Returns (sequences, mean_abundances).

        traversal='monument': bubble-tolerant Monument assembly
        (Traversal.cpp:376-724) on the unitig-jumping engine
        (traversal.UnitigJumpTraversal — simple-path stretches advance a
        whole unitig per step; bubble decisions are the per-kmer
        reference logic, output equal to the per-node oracle). Returns
        (sequences, None) — Monument contigs span bubbles, so a single
        mean abundance is not well-defined.

        min_contig_len defaults to 2k+1, Minia's contig length filter."""
        if min_contig_len is None:
            min_contig_len = 2 * self._k + 1
        if traversal == "monument":
            import time as _t

            from .traversal import assemble_contigs

            t0 = _t.time()
            seqs = assemble_contigs(self, traversal="monument",
                                    min_contig_len=min_contig_len,
                                    engine="fast")
            self.info["postsolid_time.contigs"] = round(_t.time() - t0, 3)
            return seqs, None
        ug = self.unitig_graph()
        lens = np.asarray(ug.unitig_lengths())
        keep = lens >= min_contig_len
        seqs = [s for s, k_ in zip(ug.sequences, keep) if k_]
        return seqs, np.asarray(ug.mean_abundance)[keep]

    def unitig_graph(self):
        """Compact the (live) graph into unitigs with links
        (GraphUnitigs / UnitigsConstructionAlgorithm equivalent)."""
        import time as _t

        from .graph_unitigs import build_unitig_graph

        t0 = _t.time()
        live = ~(self.node_state & 1).astype(bool)
        if live.all():
            adj = self.precompute_adjacency()
            ug = build_unitig_graph(self.solid_limbs, self.solid_counts,
                                    adj, self._k, mesh=self.mesh)
        else:
            from .simplifications import Simplifications

            simp = Simplifications(self)
            _, ug = simp._compact(self.solid_limbs[live],
                                  self.solid_counts[live])
        self.info["postsolid_time.unitigs"] = round(_t.time() - t0, 3)
        return ug

    def get_info(self) -> dict:
        info = dict(self.info)
        info.update({
            "kmer_size": self._k,
            "nb_solid_kmers": self.nb_nodes,
        })
        if self._branching is not None:
            info["nb_branching"] = len(self._branching)
            info["checksum_branching"] = self.checksum_branching()
        return info


def _plan_partitions(bank, kmer_size: int, minimizer_size: int) -> int:
    """Partition count from the configuration plan (the reference sizes
    the repartitor from it, Graph.cpp:366-384)."""
    from ..bank.fasta import open_bank
    from ..kmer.configuration import compute_plan

    try:
        n, total, mx = open_bank(bank).estimate()
        plan = compute_plan(n, total, mx, kmer_size,
                            minimizer_size=minimizer_size)
        return max(1, plan.nb_partitions)
    except (ValueError, OSError):
        return 1


def _next_pow2_int(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _popcount4(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint8)
    x = (x & 0x55) + ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x & 0x0F) + (x >> 4)
