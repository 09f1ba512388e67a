"""dbgcheck-equivalent CLI: whole-graph invariants and checksums.

Mirrors reference tools/dbgcheck.cpp:34-133 — loads (or builds) a graph and
reports, over ALL nodes: node-value checksum, successor count + successor
checksum, total abundance; over BRANCHING nodes: count, checksum, abundance.
Checksums are LargeInt sums mod 2^(64*words) printed high-word-first hex
('.'-separated), exactly like LargeInt::operator<< (LargeInt.hpp:630-648).

Device mapping: the reference's per-node Dispatcher loop over
graph.successors() becomes one batched adjacency+candidate sweep
(ops/neighbor_ops.neighbor_candidates, masked by the 8-bit adjacency masks).

Usage: python -m gatb_core_tpu.tools.dbgcheck -in graph.h5
       python -m gatb_core_tpu.tools.dbgcheck -in reads.fa -kmer-size 31
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import jax.numpy as jnp


def largeint_hex(total: int, words: int) -> str:
    """LargeInt::operator<< format: 64-bit hex words high->low, '.'
    separated, leading zero words skipped; empty string for zero."""
    total %= 1 << (64 * words)
    ws = [(total >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(words)]
    i = words - 1
    while i >= 0 and ws[i] == 0:
        i -= 1
    if i < 0:
        return ""
    return ".".join(f"{ws[j]:x}" for j in range(i, -1, -1))


def check_graph(graph) -> dict:
    """Gather dbgcheck's Stats over the whole graph (batched)."""
    from ..ops.kmer_ops import kmers_to_py
    from ..ops.neighbor_ops import neighbor_candidates
    from ..debruijn.graph import _popcount4

    t0 = time.time()
    words = max(1, (graph._k + 31) // 32)
    mod = 1 << (64 * words)

    adj = graph.precompute_adjacency()
    out_deg = _popcount4(adj & 0x0F)
    nb_successors = int(out_deg.sum())
    abundance = int(np.asarray(graph.solid_counts, np.int64).sum())
    checksum_nodes = sum(kmers_to_py(graph.solid_limbs)) % mod

    # successor checksum: batched candidates, masked by adjacency out-bits
    checksum_succ = 0
    chunk = 1 << 14
    n = graph.nb_nodes
    for i in range(0, n, chunk):
        part = graph.solid_limbs[i:i + chunk]
        cands = np.asarray(neighbor_candidates(jnp.asarray(part), graph._k))
        mask = adj[i:i + chunk]
        for b in range(4):
            sel = (mask & (1 << b)) != 0
            if sel.any():
                checksum_succ = (checksum_succ
                                 + sum(kmers_to_py(cands[sel, b]))) % mod

    branching = graph.branching_nodes()
    checksum_branching = sum(kmers_to_py(branching)) % mod
    abundance_branching = int(np.asarray(graph._branching_counts,
                                         np.int64).sum())
    return {
        "nbSolids": int(n),
        "nbSuccessors": nb_successors,
        "nbBranching": int(len(branching)),
        "checkumNodes": largeint_hex(checksum_nodes, words),
        "checksumSuccessors": largeint_hex(checksum_succ, words),
        "checksumBranching": largeint_hex(checksum_branching, words),
        "abundance": abundance,
        "abundanceBranching": abundance_branching,
        "time": time.time() - t0,
    }


def main(argv=None) -> int:
    from ..system.compile_cache import enable_compile_cache

    enable_compile_cache()
    p = argparse.ArgumentParser(prog="dbgcheck")
    p.add_argument("-in", dest="input", required=True,
                   help="graph .h5 or reads file")
    p.add_argument("-kmer-size", dest="kmer_size", type=int, default=31)
    p.add_argument("-abundance-min", dest="abundance_min", default="2")
    args = p.parse_args(argv)

    from ..debruijn.graph import Graph

    if args.input.endswith(".h5"):
        graph = Graph.load(args.input)
    else:
        amin = args.abundance_min if args.abundance_min == "auto" \
            else int(args.abundance_min)
        graph = Graph.create(args.input, kmer_size=args.kmer_size,
                             abundance_min=amin, build_branching=False)

    stats = check_graph(graph)
    print()
    for key in ("nbSolids", "nbSuccessors", "nbBranching", "checkumNodes",
                "checksumSuccessors", "checksumBranching", "abundance",
                "abundanceBranching", "time"):
        val = stats[key]
        if key == "time":
            val = f"{val:.3f}"
        print(f"{key:<18} = {val}  ")
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
