"""Unitig construction: device BCALM2 equivalent.

Reference: bcalm2/bcalm_algo.cpp (minimizer-bucket compaction) +
bglue_algo.cpp (union-find glue across buckets) + LinkTigs.cpp (unitig
links). Those structures exist to bound memory on a CPU; on the device the whole
solid-kmer set is HBM-resident, so unitig compaction is expressed as the
classic parallel list-ranking problem:

  1. oriented nodes: each canonical kmer i yields (i,+) and (i,-)
  2. succ(u) = unique out-neighbor v of u with out-degree(u) == 1 and
     in-degree(v) == 1 (the BCALM compactable-edge rule)
  3. unitigs = maximal succ-chains; found by pointer doubling
     (O(log chain-length) gather rounds — SURVEY §5.8's UF replacement)
  4. cycles (isolated circular paths) are cut at their minimal oriented
     node, matching the reference's deterministic circular handling
     (bglue_algo.cpp:216-330 determine_order_sequences handles circular)
  5. each unitig appears as two twin (RC) chains; the canonical
     representative is kept

Outputs unitig sequences, per-unitig kmer counts/mean abundance (the
``km:f:`` FASTA annotation, bglue_algo.cpp output convention) and
node->unitig position maps used for links and the unitig graph.
"""

from __future__ import annotations

from dataclasses import dataclass

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.kmer_ops import kmers_to_py
from ..ops.neighbor_ops import neighbor_candidates, revcomp_limbs
from ..kmer.model import kmer_to_string

I32 = jnp.int32


@dataclass
class UnitigSet:
    """Compact unitig representation.

    sequences: list of unitig strings (length >= k)
    mean_abundance: (U,) float32 per-unitig mean kmer count
    kmer_counts: (U,) int32 number of kmers per unitig
    node_unitig: (N,) int32 unitig id of every solid kmer
    node_pos: (N,) int32 position of the kmer within its unitig
    node_strand: (N,) int8 0 if the kmer's canonical form appears forward
                 in the unitig, 1 if reversed
    """

    sequences: list
    mean_abundance: np.ndarray
    kmer_counts: np.ndarray
    node_unitig: np.ndarray
    node_pos: np.ndarray
    node_strand: np.ndarray

    @property
    def nb_unitigs(self) -> int:
        return len(self.sequences)


def _oriented_succ(adj: np.ndarray, cand_ranks: np.ndarray,
                   cand_flip: np.ndarray) -> np.ndarray:
    """Build the successor array over oriented nodes.

    adj: (N,) uint8 adjacency masks (bits 0-3 out by nt, 4-7 in by nt)
    cand_ranks: (N, 8) int32 rank of each neighbor candidate (-1 if absent)
    cand_flip: (N, 8) int8 1 if the neighbor is entered in reverse strand
    Returns succ: (2N,) int32 oriented successor or -1.

    Oriented id: 2*i + s (s=0: canonical forward, s=1: reverse).
    out-neighbors of (i,0) are adjacency bits 0-3 (candidate slots 0-3);
    out-neighbors of (i,1) are the reverse strand's extensions, which are
    the in-candidates with complemented nucleotide: slot 4 + (nt^2).
    """
    n = adj.shape[0]
    out_bits = adj & 0x0F
    in_bits = adj >> 4

    def popcount(x):
        x = (x & 0x55) + ((x >> 1) & 0x55)
        x = (x & 0x33) + ((x >> 2) & 0x33)
        return (x & 0x0F) + (x >> 4)

    outdeg_f = popcount(out_bits)
    outdeg_r = popcount(in_bits)

    succ = np.full(2 * n, -1, np.int64)

    # forward orientation: the unique out nt (when outdeg==1)
    for nt in range(4):
        sel = (outdeg_f == 1) & (out_bits == (1 << nt))
        j = cand_ranks[sel, nt]
        flip = cand_flip[sel, nt]
        succ[2 * np.nonzero(sel)[0]] = 2 * j + flip
    # reverse orientation: out-extension with nt == in-candidate slot nt^2,
    # and the neighbor's strand is flipped relative to the candidate's
    for nt in range(4):
        slot = 4 + (nt ^ 2)
        sel = (outdeg_r == 1) & (in_bits == (1 << (nt ^ 2)))
        j = cand_ranks[sel, slot]
        flip = cand_flip[sel, slot]
        # entering via an in-candidate of the canonical form means the
        # neighbor is traversed in the opposite sense of that candidate
        succ[2 * np.nonzero(sel)[0] + 1] = 2 * j + (1 - flip)
    return succ


def _indegree_oriented(adj: np.ndarray) -> np.ndarray:
    """True graph in-degree of every oriented node, from adjacency bits.

    indeg of (i,+) = popcount(in bits); indeg of (i,-) = popcount(out bits)
    (an in-edge of the reverse orientation is an out-edge of the forward).
    """
    def popcount(x):
        x = (x & 0x55) + ((x >> 1) & 0x55)
        x = (x & 0x33) + ((x >> 2) & 0x33)
        return (x & 0x0F) + (x >> 4)

    n = adj.shape[0]
    deg = np.zeros(2 * n, np.int64)
    deg[0::2] = popcount(adj >> 4)
    deg[1::2] = popcount(adj & 0x0F)
    return deg


def _pad_self(parent: np.ndarray):
    """Pad a parent array to pow2 with self-loop sentinels so the
    doubling programs compile once per capacity bucket (r4: shape drift
    across simplify recompactions caused hundreds of recompiles)."""
    from ..ops.sortops import _next_pow2

    m = len(parent)
    cap = _next_pow2(max(m, 2))
    if cap == m:
        return parent, m
    out = np.empty(cap, parent.dtype)
    out[:m] = parent
    out[m:] = np.arange(m, cap)
    return out, m


def _pointer_double(parent: np.ndarray):
    """List ranking: returns (root, rank) after full pointer doubling.

    parent[v] == v marks a head. Cycles must have been cut beforehand.
    """
    parent, m = _pad_self(np.asarray(parent))
    parent = jnp.asarray(parent, I32)
    cap = parent.shape[0]
    rank = jnp.where(parent == jnp.arange(cap, dtype=I32), 0, 1).astype(I32)
    rounds = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)

    def body(_, state):
        par, rk = state
        rk = rk + rk[par]
        par = par[par]
        return par, rk

    parent, rank = jax.lax.fori_loop(0, rounds, body, (parent, rank))
    return np.asarray(parent)[:m], np.asarray(rank)[:m]


def _cut_cycles(parent: np.ndarray) -> np.ndarray:
    """Cut each pure cycle at its minimal member (deterministic)."""
    m = len(parent)
    par_p, _ = _pad_self(np.asarray(parent))
    par = jnp.asarray(par_p, I32)
    cap = par.shape[0]
    minid = jnp.arange(cap, dtype=I32)
    rounds = max(1, int(np.ceil(np.log2(max(cap, 2)))) + 1)

    def body(_, state):
        par, mn = state
        mn = jnp.minimum(mn, mn[par])
        par = par[par]
        return par, mn

    roots, minid = jax.lax.fori_loop(0, rounds, body, (par, minid))
    roots = np.asarray(roots)[:m]
    minid = np.asarray(minid)[:m]
    # a node is in a cycle iff its final root is not a head
    is_head = parent == np.arange(m)
    cyclic = ~is_head[roots]
    cut = cyclic & (minid == np.arange(m))
    out = parent.copy()
    out[cut] = np.nonzero(cut)[0]
    return out, cut


def _popcount4_j(x):
    """Popcount of the low 4 bits of an int32 array (traced)."""
    x = x & 0x0F
    x = (x & 0x55) + ((x >> 1) & 0x55)
    return (x & 0x33) + ((x >> 2) & 0x33)


def _succ_cut_rank(ranks, flips, adj, n):
    """Traced body shared by the fused compaction kernels: oriented
    successors (BCALM compactable-edge rule) + predecessor chains +
    cycle cutting + full pointer-doubling list ranking — the whole
    oriented-chain computation in ONE device program (r5: the split
    host/device pipeline paid ~6 dispatches + a 40 MB cand-rank fetch
    per compaction).

    ranks/flips: (C, 8) int32/int8 candidate ranks and strand flips;
    adj: (C,) uint8 adjacency masks; n: traced live row count.
    Returns (roots (2C,) i32, rank (2C,) i32, cut (2C,) bool) —
    rows >= 2n are self-loop padding."""
    C = adj.shape[0]
    adj = adj.astype(jnp.int32)
    out_bits = adj & 0x0F
    in_bits = (adj >> 4) & 0x0F
    outdeg_f = _popcount4_j(out_bits)
    outdeg_r = _popcount4_j(in_bits)
    ranks = ranks.astype(I32)
    flips = flips.astype(I32)
    succ_f = jnp.full((C,), -1, I32)
    succ_r = jnp.full((C,), -1, I32)
    for nt in range(4):
        sel = (outdeg_f == 1) & (out_bits == (1 << nt))
        succ_f = jnp.where(sel & (ranks[:, nt] >= 0),
                           2 * ranks[:, nt] + flips[:, nt], succ_f)
        slot = 4 + (nt ^ 2)
        sel_r = (outdeg_r == 1) & (in_bits == (1 << (nt ^ 2)))
        succ_r = jnp.where(sel_r & (ranks[:, slot] >= 0),
                           2 * ranks[:, slot] + (1 - flips[:, slot]),
                           succ_r)
    succ = jnp.stack([succ_f, succ_r], axis=1).reshape(2 * C)
    ids = jax.lax.broadcasted_iota(I32, (2 * C,), 0)
    twin = ids ^ 1
    # indeg of (i,+) = popcount(in bits); of (i,-) = popcount(out bits)
    indeg = jnp.stack([_popcount4_j(in_bits), _popcount4_j(out_bits)],
                      axis=1).reshape(2 * C)
    tgt_ok = succ >= 0
    tgtc = jnp.clip(succ, 0, 2 * C - 1)
    bad = tgt_ok & ((indeg[tgtc] != 1) | (succ == ids) | (succ == twin))
    succ = jnp.where(bad, -1, succ)
    # pred(v) = twin(succ(twin(v))); rows >= 2n are self-loops
    succ_twin = succ.reshape(C, 2)[:, ::-1].reshape(2 * C)
    pred = jnp.where(succ_twin >= 0, succ_twin ^ 1, ids)
    has_pred = pred != ids
    pv = jnp.clip(pred, 0, 2 * C - 1)
    sym_ok = succ[pv] == ids
    pred = jnp.where(has_pred & ~sym_ok, ids, pred)
    pred = jnp.where(ids >= 2 * n, ids, pred)
    # cycle cut at each cycle's minimal member (deterministic)
    rounds = max(1, int(np.ceil(np.log2(max(2 * C, 2)))) + 1)

    def cyc_body(_, state):
        par, mn = state
        mn = jnp.minimum(mn, mn[par])
        par = par[par]
        return par, mn

    roots0, minid = jax.lax.fori_loop(0, rounds, cyc_body, (pred, ids))
    is_head0 = pred == ids
    cyclic = ~is_head0[roots0]
    cut = cyclic & (minid == ids)
    par1 = jnp.where(cut, ids, pred)
    # list ranking by pointer doubling
    rank = jnp.where(par1 == ids, 0, 1).astype(I32)

    def dbl_body(_, state):
        par, rk = state
        rk = rk + rk[par]
        par = par[par]
        return par, rk

    roots, rank = jax.lax.fori_loop(0, rounds, dbl_body, (par1, rank))
    return roots, rank, cut


@functools.partial(jax.jit, static_argnames=("k",))
def _compact_table_kernel(table, adj, n, k: int):
    """Fused unitig compaction: candidate sort-join + successor rule +
    cycle cut + list ranking, one dispatch (the r4 pipeline was ~6
    chained dispatches + host round-trips). table: (C, W) pow2-padded
    sorted solid kmers; adj: (C,) uint8; n traced."""
    ranks, flips = _cand_ranks_flips(table, table, n, k)
    return _succ_cut_rank(ranks, flips, adj, n)


@jax.jit
def _compact_from_cands_kernel(ranks, flips, adj, n):
    """Fused compaction from precomputed candidate ranks/flips (the
    simplify-recompaction path remaps host-side, then runs succ + cut +
    ranking in one dispatch)."""
    return _succ_cut_rank(ranks, flips, adj, n)


def build_unitigs(solid_limbs: np.ndarray, solid_counts: np.ndarray,
                  adjacency: np.ndarray, k: int,
                  chunk: int | None = None, mesh=None,
                  precomputed=None, lazy_sequences: bool = False) -> UnitigSet:
    """Compact the solid-kmer graph into unitigs (bcalm2+bglue+links
    equivalent, UnitigsConstructionAlgorithm.cpp:90-117). With ``mesh``,
    the candidate-rank sweep and the list-ranking rounds run sharded
    over the device mesh (parallel/postsolid.py) — results are
    bit-identical to the single-device path."""
    n = len(solid_limbs)
    if n == 0:
        return UnitigSet([], np.zeros(0, np.float32), np.zeros(0, np.int32),
                         np.zeros(0, np.int32), np.zeros(0, np.int32),
                         np.zeros(0, np.int8))
    w = solid_limbs.shape[1]

    # --- oriented chains: fused one-dispatch path ----------------------
    if mesh is not None:
        from ..parallel.postsolid import (distributed_cand_ranks,
                                          distributed_cut_cycles,
                                          distributed_pointer_double)

        if precomputed is not None:
            # remapped ranks from the simplify recompaction sweep (whose
            # own full sweep ran mesh-sharded) — the chain ranking below
            # still goes over the mesh
            cand_ranks, cand_flip = precomputed
        else:
            cand_ranks, cand_flip = distributed_cand_ranks(
                mesh, solid_limbs, k)
        succ = _oriented_succ(adjacency, cand_ranks, cand_flip)
        indeg = _indegree_oriented(adjacency)
        ids = np.arange(2 * n)
        twin = ids ^ 1
        tgt_ok = succ >= 0
        bad = np.zeros(2 * n, bool)
        bad[tgt_ok] = (indeg[succ[tgt_ok]] != 1) \
            | (succ[tgt_ok] == ids[tgt_ok]) \
            | (succ[tgt_ok] == twin[tgt_ok])
        succ[bad] = -1
        # pred(v) = twin(succ(twin(v))), symmetry-enforced
        succ_twin = succ[twin]
        pred = np.where(succ_twin >= 0, succ_twin ^ 1, ids)
        has_pred = pred != ids
        pv = pred[has_pred]
        ok = succ[pv] == ids[has_pred]
        fix = np.nonzero(has_pred)[0][~ok]
        pred[fix] = fix
        pred, cycle_cut = distributed_cut_cycles(mesh, pred)
        roots, rank = distributed_pointer_double(mesh, pred)
    else:
        from ..ops.sortops import _next_pow2, pad_rows_pow2, sweep_chunk

        ptab, _ = pad_rows_pow2(solid_limbs)
        cap = len(ptab)
        adj_p = np.zeros(cap, np.uint8)
        adj_p[:n] = adjacency
        if precomputed is not None:
            # caller-supplied (N, 8) ranks/flips (Simplifications'
            # remapped sweep): succ + cut + ranking in one dispatch
            cand_ranks, cand_flip = precomputed
            rk_p = np.full((cap, 8), -1, np.int32)
            rk_p[:n] = cand_ranks
            fl_p = np.zeros((cap, 8), np.int8)
            fl_p[:n] = cand_flip
            roots_j, rank_j, cut_j = _compact_from_cands_kernel(
                jnp.asarray(rk_p), jnp.asarray(fl_p),
                jnp.asarray(adj_p), jnp.int32(n))
        elif cap <= (chunk or (1 << 22)):
            # candidate join + successors + cycle cut + list ranking in
            # ONE dispatch (instead of ~6 chained dispatches + an (N, 8)
            # rank fetch)
            roots_j, rank_j, cut_j = _compact_table_kernel(
                jnp.asarray(ptab), jnp.asarray(adj_p), jnp.int32(n), k)
        else:
            # giant tables: chunked candidate sweep (bounds the 8C-row
            # sort-join), then one fused succ/cut/rank dispatch
            table = jnp.asarray(ptab)
            rk_p = np.full((cap, 8), -1, np.int32)
            fl_p = np.zeros((cap, 8), np.int8)
            csize = min(sweep_chunk(n), cap)
            if chunk:
                csize = min(csize, chunk)
            for i in range(0, n, csize):
                part = solid_limbs[i:i + csize]
                npart = len(part)
                if npart < csize:
                    part = np.concatenate(
                        [part, np.zeros((csize - npart, w), np.uint32)])
                r, fl = _cand_ranks_flips(jnp.asarray(part), table,
                                          jnp.int32(n), k)
                rk_p[i:i + npart] = np.asarray(r)[:npart]
                fl_p[i:i + npart] = np.asarray(fl)[:npart]
            roots_j, rank_j, cut_j = _compact_from_cands_kernel(
                jnp.asarray(rk_p), jnp.asarray(fl_p),
                jnp.asarray(adj_p), jnp.int32(n))
        roots, rank, cycle_cut = jax.device_get(
            (roots_j, rank_j, cut_j))
        roots = roots[:2 * n].astype(np.int64)
        rank = rank[:2 * n]
        cycle_cut = cycle_cut[:2 * n]
        ids = np.arange(2 * n)
        twin = ids ^ 1

    # --- chains + twin dedup ------------------------------------------
    # chain id = root oriented node; the twin (RC) chain's root is the
    # twin of this chain's tail. Keep one representative per twin pair.
    uniq_roots, root_index, counts_per_chain = np.unique(
        roots, return_inverse=True, return_counts=True)
    chain_len = counts_per_chain[root_index]
    is_tail = rank == chain_len - 1
    twin_root_of = np.zeros(len(uniq_roots), np.int64)
    twin_root_of[root_index[is_tail]] = twin[is_tail]
    # chains cut from cycles: the twin chain is the twin cycle cut at the
    # twin of OUR head (see _cut_cycles minima argument), not twin(tail)
    cyclic_chain = cycle_cut[uniq_roots]
    twin_root_of = np.where(cyclic_chain, twin[uniq_roots], twin_root_of)
    keep_chain = uniq_roots <= twin_root_of

    # --- per-node unitig assignment ------------------------------------
    # kept chains get dense unitig ids
    kept_ids = np.cumsum(keep_chain) - 1
    node_or = ids  # oriented ids
    chain_of_node = root_index  # index into uniq_roots
    in_kept = keep_chain[chain_of_node]

    node_unitig = np.full(n, -1, np.int32)
    node_pos = np.zeros(n, np.int32)
    node_strand = np.zeros(n, np.int8)
    sel = in_kept
    base_ids = node_or[sel] >> 1
    node_unitig[base_ids] = kept_ids[chain_of_node[sel]]
    node_pos[base_ids] = rank[sel]
    node_strand[base_ids] = (node_or[sel] & 1).astype(np.int8)

    # --- emit sequences -------------------------------------------------
    nb_unitigs = int(keep_chain.sum())
    lengths = counts_per_chain[keep_chain]
    if lazy_sequences:
        seqs = LazySequences(
            lambda nu=node_unitig.copy(), npos=node_pos.copy(),
            nstr=node_strand.copy(): _emit_sequences(
                solid_limbs, k, nu, npos, nstr, nb_unitigs, lengths),
            lengths + k - 1)
    else:
        seqs = _emit_sequences(solid_limbs, k, node_unitig, node_pos,
                               node_strand, nb_unitigs, lengths)

    # --- abundance ------------------------------------------------------
    kmer_counts = np.zeros(nb_unitigs, np.int64)
    sum_ab = np.zeros(nb_unitigs, np.float64)
    valid = node_unitig >= 0
    np.add.at(kmer_counts, node_unitig[valid], 1)
    np.add.at(sum_ab, node_unitig[valid], solid_counts[valid])
    mean_ab = (sum_ab / np.maximum(kmer_counts, 1)).astype(np.float32)

    return UnitigSet(seqs, mean_ab, kmer_counts.astype(np.int32),
                     node_unitig, node_pos, node_strand)


def _cand_kernel(k: int, n_table: int, chunk: int):
    """Thin wrapper keeping the historical (k, n, chunk) factory shape;
    the jitted body takes n_table TRACED so one compile serves every
    table size in a pow2 capacity bucket."""
    def kernel(nodes, table):
        return _cand_ranks_flips(nodes, table, jnp.int32(n_table), k)

    return kernel


@functools.partial(jax.jit, static_argnames=("k",))
def _cand_ranks_flips(nodes, table, n_table, k: int):
    cands = neighbor_candidates(nodes, k)   # (C, 8, W)
    c, _, w = cands.shape
    flat = cands.reshape(c * 8, w)
    # sort-join ranks (ops/sortops.rank_join): bcalm2's candidate
    # lookups without the log(n)-gathers-per-query binary search
    from ..ops.sortops import rank_join_traced

    pos, found = rank_join_traced(table, flat, n_table)
    ranks = jnp.where(found, pos, -1).reshape(c, 8).astype(I32)
    # strand of the neighbor: candidate equals its canonical form iff
    # the extension's forward form == canonical; flip=1 otherwise.
    # Out-candidates (slots 0-3): fwd ext = (f<<2)|nt — flip if
    # canonical(ext) != fwd ext. In-candidates: fwd ext = (f>>2)|nt<<..
    from ..ops.neighbor_ops import shl2_or, shr2_or_top, revcomp_limbs
    f = nodes
    r = revcomp_limbs(nodes, k)
    flips = []
    U32 = jnp.uint32
    for nt in range(4):
        cnt = jnp.full((c,), nt, U32)
        fwd = shl2_or(f, cnt, k)
        flips.append(jnp.any(fwd != cands[:, nt], axis=-1))
    for nt in range(4):
        cnt = jnp.full((c,), nt, U32)
        fwd = shr2_or_top(f, cnt, k)
        flips.append(jnp.any(fwd != cands[:, 4 + nt], axis=-1))
    flip = jnp.stack(flips, axis=1).astype(jnp.int8)
    return ranks, flip


class PackedSequences:
    """2-bit packed unitig store (the reference's packed_unitigs blob +
    dag_vector offsets, GraphUnitigs.cpp:520-660): ~4x+ less RAM than
    Python strings, decoded to str lazily on access. Duck-types a list of
    strings (len / index / iterate)."""

    _DECODE = np.frombuffer(b"ACTG", dtype=np.uint8)

    def __init__(self, packed: np.ndarray, byte_offsets: np.ndarray,
                 lengths: np.ndarray):
        self._packed = packed            # (B,) uint8, 4 codes/byte
        self._byte_offsets = byte_offsets  # (U+1,) byte offset per unitig
        self._lengths = lengths          # (U,) base lengths

    @classmethod
    def from_ascii_buffer(cls, chars: np.ndarray,
                          offsets: np.ndarray) -> "PackedSequences":
        lengths = np.diff(offsets).astype(np.int64)
        code = np.zeros(256, np.uint8)
        code[ord("C")] = 1
        code[ord("T")] = 2
        code[ord("G")] = 3
        codes = code[chars]
        nbytes = (lengths + 3) // 4
        byte_offsets = np.zeros(len(lengths) + 1, np.int64)
        byte_offsets[1:] = np.cumsum(nbytes)
        # scatter each base to its byte-aligned position in the blob
        total = int(lengths.sum())
        within = np.arange(total, dtype=np.int64) \
            - np.repeat(offsets[:-1].astype(np.int64), lengths)
        dest = np.repeat(byte_offsets[:-1] * 4, lengths) + within
        padded = np.zeros(int(byte_offsets[-1]) * 4, np.uint8)
        padded[dest] = codes
        q = padded.reshape(-1, 4)
        packed = ((q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2)
                  | q[:, 3]).astype(np.uint8)
        return cls(packed, byte_offsets, lengths)

    def lengths(self) -> np.ndarray:
        return self._lengths

    def nbytes(self) -> int:
        return self._packed.nbytes + self._byte_offsets.nbytes \
            + self._lengths.nbytes

    def __len__(self) -> int:
        return len(self._lengths)

    def __getitem__(self, i: int) -> str:
        if isinstance(i, (slice, list, np.ndarray)):
            idx = range(*i.indices(len(self))) if isinstance(i, slice) \
                else np.atleast_1d(i)
            return [self[int(j)] for j in idx]
        b = self._packed[self._byte_offsets[i]:self._byte_offsets[i + 1]]
        codes = np.empty(len(b) * 4, np.uint8)
        codes[0::4] = b >> 6
        codes[1::4] = (b >> 4) & 3
        codes[2::4] = (b >> 2) & 3
        codes[3::4] = b & 3
        return self._DECODE[codes[:self._lengths[i]]].tobytes() \
            .decode("ascii")

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        return list(self) == list(other)


class LazySequences:
    """Deferred `_emit_sequences`: serves lengths immediately (unitig
    base length = nk + k - 1, no decode needed) and materializes the
    PackedSequences blob on first element access. Simplify's tip/EC/
    bulge passes never spell sequences, so their 19 recompactions skip
    the emit entirely (r4: ~11 s of a 44 s reads3 simplify)."""

    def __init__(self, emit, lengths):
        self._emit = emit
        self._lengths = np.asarray(lengths, np.int64)
        self._mat = None

    def _materialize(self):
        if self._mat is None:
            self._mat = self._emit()
            self._emit = None
        return self._mat

    def lengths(self) -> np.ndarray:
        return self._lengths

    def __len__(self) -> int:
        return len(self._lengths)

    def __getitem__(self, i):
        return self._materialize()[i]

    def __iter__(self):
        return iter(self._materialize())

    def __eq__(self, other):
        return list(self) == list(other)


def _emit_sequences(solid_limbs, k, node_unitig, node_pos, node_strand,
                    nb_unitigs, lengths):
    """Assemble unitig strings on host from per-node assignments.

    Vectorized: the last character of each node's *oriented* kmer is
    computed from the limb array directly (low 2 bits for forward strand,
    complemented top 2 bits for reverse); only the U head kmers (pos==0)
    need full decoding.
    """
    if nb_unitigs == 0:
        return PackedSequences(np.zeros(0, np.uint8),
                               np.zeros(1, np.int64), np.zeros(0, np.int64))
    total_chars = int((lengths + k - 1).sum())
    offsets = np.zeros(nb_unitigs + 1, np.int64)
    offsets[1:] = np.cumsum(lengths + k - 1)
    chars = np.zeros(total_chars, dtype=np.uint8)
    nts = np.frombuffer(b"ACTG", dtype=np.uint8)

    valid = node_unitig >= 0
    uids = node_unitig[valid]
    poss = node_pos[valid]
    strands = node_strand[valid]
    limbs = solid_limbs[valid]

    # last char of oriented kmer
    low2 = (limbs[:, -1] & 3).astype(np.uint8)
    bitpos = 2 * k - 2
    jtop = limbs.shape[1] - 1 - bitpos // 32
    top2 = ((limbs[:, jtop] >> (bitpos % 32)) & 3).astype(np.uint8)
    last = np.where(strands == 0, low2, top2 ^ 2)

    ext = poss > 0
    chars[offsets[uids[ext]] + k - 1 + poss[ext]] = nts[last[ext]]

    # heads: full oriented kmer decode, vectorized over all heads
    # (round 1 decoded per-kmer in Python — scale-hostile at >=100k unitigs)
    head_sel = poss == 0
    if head_sel.any():
        import jax.numpy as jnp

        from ..ops.neighbor_ops import revcomp_limbs

        hl = limbs[head_sel]
        hs = strands[head_sel]
        from ..ops.sortops import _next_pow2

        hcap = _next_pow2(max(len(hl), 1))
        hpad = np.zeros((hcap, hl.shape[1]), hl.dtype)
        hpad[:len(hl)] = hl
        rc = np.asarray(revcomp_limbs(jnp.asarray(hpad), k))[:len(hl)]
        ol = np.where(hs[:, None] == 0, hl, rc)       # oriented limbs
        base = offsets[uids[head_sel]]
        w32 = ol.shape[1]
        for i in range(k):                             # k vectorized steps
            bitpos = 2 * (k - 1 - i)
            jlimb = w32 - 1 - bitpos // 32
            code = (ol[:, jlimb] >> (bitpos % 32)) & 3
            chars[base + i] = nts[code.astype(np.uint8)]
    # packed 2-bit store (no Python string per unitig: memory-safe at
    # >=100k unitigs, decoded lazily on access)
    return PackedSequences.from_ascii_buffer(chars, offsets)
