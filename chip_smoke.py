#!/usr/bin/env python3
"""Smoke run of the dbgh5 graph build on one NVIDIA GPU.

    python chip_smoke.py [--seed N] [--work-dir DIR] [--four-cards]

One process reserves the card once and drives the system through the
entry points a user calls:

  bank      a random genome of 4,641,652 bp (the size of E. coli K-12
            MG1655), 150 bp reads at 30x (928,330 reads) from both
            strands with 0.5 % substitution errors, written as FASTA;
  dbgh5     ``gatb_core_tpu.tools.dbgh5.main`` in-process with the
            settings of upstream's functional test (-kmer-size 31
            -abundance-min 3): counting, MPHF, Bloom, cascading debloom,
            branching nodes, stored graph;
  check     the solid table (key by key, count by count), the histogram
            and nb_branching against an independent numpy oracle;
  assembly  unitigs, simplify and Monument contigs of the stored graph:
            every solid k-mer lies in exactly one unitig, every contig
            k-mer is solid;
  k63       a k=63 count of the same bank against the same oracle.

``--four-cards`` runs only the mesh phase: sharded counting, postsolid,
unitigs, simplify and Monument contigs on a 1-D mesh of four cards,
compared with the same stages on one card.

Every check is bit-for-bit. The script exits non-zero, and prints no
result line, when JAX's first device is not a GPU, when the native FASTA
parser cannot be built, or when any phase fails. Its last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

GENOME_LEN = 4_641_652
READ_LEN = 150
COVERAGE = 30
NB_READS = GENOME_LEN * COVERAGE // READ_LEN          # 928,330
ERROR_RATE = 0.005
KMER_SIZE = 31
ABUNDANCE_MIN = 3
HISTO_MAX = 10000

_LETTERS = np.frombuffer(b"ACTG", np.uint8)           # code -> base
_CODES = np.full(256, 255, np.uint8)                  # base -> code
_CODES[np.frombuffer(b"ACTG", np.uint8)] = np.arange(4, dtype=np.uint8)


# ---------------------------------------------------------------------------
# bank
# ---------------------------------------------------------------------------


def make_reads(genome_len: int, nb_reads: int, read_len: int,
               error_rate: float, seed: int) -> np.ndarray:
    """(nb_reads, read_len) uint8 2-bit codes (A=0 C=1 T=2 G=3) sampled
    uniformly from both strands of a random genome, with substitution
    errors at ``error_rate`` per base."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len + 1, nb_reads)
    reads = np.lib.stride_tricks.sliding_window_view(
        genome, read_len)[starts].copy()
    flip = rng.random(nb_reads) < 0.5
    reads[flip] = reads[flip, ::-1] ^ np.uint8(2)
    err = rng.random(reads.shape) < error_rate
    reads[err] = (reads[err] + rng.integers(1, 4, int(err.sum()),
                                            dtype=np.uint8)) & np.uint8(3)
    return reads


def write_fasta(path: str, reads: np.ndarray) -> None:
    seqs = _LETTERS[reads]
    with open(path, "wb") as f:
        f.write(b"".join(b">r%d\n%s\n" % (i, row.tobytes())
                         for i, row in enumerate(seqs)))


def seqs_to_codes(seqs) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Concatenated codes of ACGT strings, their start offsets and
    lengths."""
    lens = np.fromiter((len(s) for s in seqs), np.int64, len(seqs))
    flat = _CODES[np.frombuffer("".join(seqs).encode("ascii"), np.uint8)]
    if (flat == 255).any():
        raise ValueError("non-ACGT base in sequence")
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return flat, offs, lens


# ---------------------------------------------------------------------------
# numpy oracle (independent of the engine's JAX code)
# ---------------------------------------------------------------------------


def _canonical(base, k: int) -> np.ndarray:
    """Canonical values of a set of k-mers as (n, nw) uint64 words, most
    significant first (nw = 1 for k <= 32, 2 for k <= 64); the low word
    holds the last min(k, 32) bases. ``base(i)`` gives the 2-bit code of
    base i (0 <= i < k) of every k-mer."""
    if not 1 <= k <= 64:
        raise ValueError("oracle supports k <= 64")
    n_lo = min(k, 32)
    n_hi = k - n_lo

    def pack(pos, comp):
        # comp=False: forward word of bases pos; True: revcomp word
        w = None
        for j in pos:
            c = base(k - 1 - j if comp else j).astype(np.uint64)
            if comp:
                c ^= np.uint64(2)
            if w is None:
                w = c
            else:
                w <<= np.uint64(2)
                w |= c
        return w.reshape(-1)

    f_lo = pack(range(n_hi, k), False)
    r_lo = pack(range(n_hi, k), True)
    if n_hi == 0:
        return np.minimum(f_lo, r_lo)[:, None]
    f_hi = pack(range(n_hi), False)
    r_hi = pack(range(n_hi), True)
    fwd_lt = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    return np.stack([np.where(fwd_lt, f_hi, r_hi),
                     np.where(fwd_lt, f_lo, r_lo)], axis=1)


def canonical_words(codes: np.ndarray, starts: np.ndarray,
                    k: int) -> np.ndarray:
    """Canonical words of the k-mers at ``starts`` in the flat code
    array (see ``_canonical``)."""
    starts = np.asarray(starts, np.int64)
    return _canonical(lambda i: codes[starts + i], k)


def read_kmers(reads: np.ndarray, k: int,
               chunk_reads: int = 1 << 16) -> np.ndarray:
    """Canonical words of every window of fixed-length reads, read by
    read, window by window."""
    p = reads.shape[1] - k + 1
    out = []
    for i in range(0, len(reads), chunk_reads):
        part = reads[i:i + chunk_reads]
        out.append(_canonical(lambda j: part[:, j:j + p], k))
    return np.concatenate(out)


def unique_counts(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Sorted distinct rows of (n, nw) uint64 words + multiplicities."""
    if words.shape[1] == 1:
        keys, counts = np.unique(words[:, 0], return_counts=True)
        return keys[:, None], counts
    order = np.lexsort(tuple(words[:, j]
                             for j in range(words.shape[1] - 1, -1, -1)))
    s = words[order]
    new = np.ones(len(s), bool)
    new[1:] = (s[1:] != s[:-1]).any(axis=1)
    idx = np.flatnonzero(new)
    return s[idx], np.diff(np.append(idx, len(s)))


def oracle_count(reads: np.ndarray, k: int, abundance_min: int):
    """(solid keys (n, nw) uint64, solid counts, histogram bins 0..max)."""
    keys, counts = unique_counts(read_kmers(reads, k))
    hist = np.bincount(np.minimum(counts, HISTO_MAX),
                       minlength=HISTO_MAX + 1)
    solid = counts >= abundance_min
    return keys[solid], counts[solid], hist


def limbs_to_words(limbs: np.ndarray) -> np.ndarray:
    """Engine (N, W) big-endian uint32 limbs -> (N, ceil(W/2)) uint64."""
    limbs = np.asarray(limbs, np.uint64)
    if limbs.shape[1] % 2:
        limbs = np.concatenate(
            [np.zeros((len(limbs), 1), np.uint64), limbs], axis=1)
    return (limbs[:, 0::2] << np.uint64(32)) | limbs[:, 1::2]


def revcomp_u64(v: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros_like(v)
    for _ in range(k):
        out = (out << np.uint64(2)) | ((v & np.uint64(3)) ^ np.uint64(2))
        v = v >> np.uint64(2)
    return out


def oracle_nb_branching(keys: np.ndarray, k: int) -> int:
    """Number of solid k-mers (sorted canonical uint64, k <= 31) whose
    in- or out-degree in the de Bruijn graph of the set is not 1."""
    mask = np.uint64((1 << (2 * k)) - 1)

    def member(q):
        q = np.minimum(q, revcomp_u64(q, k))
        i = np.minimum(np.searchsorted(keys, q), len(keys) - 1)
        return keys[i] == q

    outd = np.zeros(len(keys), np.int64)
    ind = np.zeros(len(keys), np.int64)
    for c in range(4):
        cc = np.uint64(c)
        outd += member(((keys << np.uint64(2)) | cc) & mask)
        ind += member((keys >> np.uint64(2))
                      | (cc << np.uint64(2 * (k - 1))))
    return int(((outd != 1) | (ind != 1)).sum())


def seq_kmers(seqs, k: int) -> np.ndarray:
    """Canonical words (n, nw) of every k-mer of every sequence."""
    flat, offs, lens = seqs_to_codes(list(seqs))
    nwin = np.maximum(lens - k + 1, 0)
    first = np.repeat(offs, nwin)
    within = np.arange(int(nwin.sum()), dtype=np.int64) \
        - np.repeat(np.cumsum(nwin) - nwin, nwin)
    return canonical_words(flat, first + within, k)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def check_table(limbs, counts, keys, ocounts, what: str) -> None:
    got = limbs_to_words(limbs)
    _check(got.shape == keys.shape,
           f"{what}: {got.shape[0]} solid k-mers, oracle {keys.shape[0]}")
    _check(np.array_equal(got, keys), f"{what}: solid keys differ")
    _check(np.array_equal(np.asarray(counts, np.int64),
                          ocounts.astype(np.int64)),
           f"{what}: solid counts differ")


def check_histogram(rec, hist: np.ndarray) -> None:
    """Stored /histogram/histogram (rows 1..max) against the oracle."""
    got = np.zeros_like(hist)
    got[np.asarray(rec["index"], np.int64)] = np.asarray(rec["abundance"])
    _check(np.array_equal(got[1:], hist[1:]), "histogram differs")


def check_unitigs(ug, solid_words: np.ndarray, k: int) -> int:
    kms = seq_kmers(ug.sequences, k)
    _check(len(kms) == len(solid_words),
           f"unitigs hold {len(kms)} k-mers, {len(solid_words)} solid")
    u, _ = unique_counts(kms)
    _check(np.array_equal(u, solid_words),
           "unitig k-mers are not exactly the solid set")
    return len(kms)


def check_contigs(contigs, solid_words: np.ndarray, k: int) -> int:
    kms = seq_kmers(contigs, k)[:, 0]
    keys = solid_words[:, 0]
    i = np.minimum(np.searchsorted(keys, kms), len(keys) - 1)
    _check(bool((keys[i] == kms).all()), "a contig k-mer is not solid")
    return len(kms)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


class Recorder:
    """Phase wall times and the share of them spent compiling."""

    def __init__(self):
        self.compile_s = 0.0
        self.phases: list[tuple[str, float, float]] = []
        import jax.monitoring

        def listener(event, duration, **_):
            if event.startswith("/jax/core/compile/"):
                self.compile_s += duration

        jax.monitoring.register_event_duration_secs_listener(listener)

    def run(self, name: str, fn, *args, **kwargs):
        c0, t0 = self.compile_s, time.time()
        out = fn(*args, **kwargs)
        wall = time.time() - t0
        self.phases.append((name, wall, self.compile_s - c0))
        print(f"[phase] {name}: {wall:.3f} s wall, "
              f"{self.compile_s - c0:.3f} s compiling", flush=True)
        return out


def phase_bank(work: str, seed: int, genome_len: int = GENOME_LEN,
               nb_reads: int = NB_READS, read_len: int = READ_LEN):
    reads = make_reads(genome_len, nb_reads, read_len, ERROR_RATE, seed)
    path = os.path.join(work, "reads.fa")
    write_fasta(path, reads)
    return path, reads


def phase_dbgh5(bank: str, out: str, k: int = KMER_SIZE,
                abundance_min: int = ABUNDANCE_MIN, extra=()):
    """dbgh5 in-process (``extra``: more CLI flags), then the stored graph
    reopened."""
    from gatb_core_tpu.debruijn.graph import Graph
    from gatb_core_tpu.tools import dbgh5

    rc = dbgh5.main(["-in", bank, "-out", out, "-kmer-size", str(k),
                     "-abundance-min", str(abundance_min), *extra])
    _check(rc == 0, f"dbgh5 exited {rc}")
    return Graph.load(out)


def phase_check(graph, reads: np.ndarray, k: int = KMER_SIZE,
                abundance_min: int = ABUNDANCE_MIN) -> dict:
    keys, counts, hist = oracle_count(reads, k, abundance_min)
    check_table(graph.solid_limbs, graph.solid_counts, keys, counts,
                f"dbgh5 k={k}")
    check_histogram(graph.storage.group("histogram")
                    .get_dataset("histogram"), hist)
    nb_branching = len(graph.branching_nodes())
    exp = oracle_nb_branching(keys[:, 0], k)
    _check(nb_branching == exp,
           f"nb_branching {nb_branching}, oracle {exp}")
    return {"nb_solid": int(len(keys)), "nb_distinct": int(hist.sum()),
            "nb_branching": nb_branching, "solid_words": keys}


def phase_assembly(graph, solid_words: np.ndarray,
                   k: int = KMER_SIZE) -> dict:
    ug = graph.unitig_graph()
    nk = check_unitigs(ug, solid_words, k)
    stats = graph.simplify()
    contigs, _ = graph.contigs(traversal="monument")
    _check(len(contigs) > 0, "no Monument contigs")
    ck = check_contigs(contigs, solid_words, k)
    return {"nb_unitigs": int(ug.nb_unitigs), "unitig_kmers": nk,
            "tips": stats.tips_removed, "bulges": stats.bulges_removed,
            "ec": stats.ec_removed, "nb_contigs": len(contigs),
            "contig_kmers": ck}


def phase_k63(bank: str, reads: np.ndarray,
              abundance_min: int = ABUNDANCE_MIN, **count_args) -> dict:
    from gatb_core_tpu.kmer.counting import count_kmers

    res = count_kmers(bank, kmer_size=63, abundance_min=abundance_min,
                      **count_args)
    keys, counts, hist = oracle_count(reads, 63, abundance_min)
    check_table(res.solid_kmers, res.solid_counts, keys, counts, "k=63")
    _check(np.array_equal(res.histogram.bins[1:].astype(np.int64),
                          hist[1:]), "k=63 histogram differs")
    return {"nb_solid_k63": int(len(keys))}


def phase_four_cards(bank: str, n_devices: int = 4, k: int = KMER_SIZE,
                     abundance_min: int = ABUNDANCE_MIN,
                     **count_args) -> dict:
    """Sharded count + postsolid + unitigs + simplify + Monument contigs
    on a 1-D mesh, each compared with the same stage on one device."""
    from gatb_core_tpu.debruijn.graph import Graph
    from gatb_core_tpu.kmer.counting import count_kmers
    from gatb_core_tpu.parallel.exchange import count_kmers_distributed
    from gatb_core_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(n_devices)
    res_m = count_kmers_distributed(bank, mesh, kmer_size=k,
                                    abundance_min=abundance_min,
                                    **count_args)
    res_1 = count_kmers(bank, kmer_size=k, abundance_min=abundance_min,
                        **count_args)
    _check(np.array_equal(res_m.solid_kmers, res_1.solid_kmers)
           and np.array_equal(res_m.solid_counts, res_1.solid_counts),
           "sharded solid table differs from one device")
    g_m = Graph(k, res_m.solid_kmers, res_m.solid_counts, mesh=mesh)
    g_1 = Graph(k, res_1.solid_kmers, res_1.solid_counts)
    for g in (g_m, g_1):
        g.build_postsolid()
    _check(np.array_equal(g_m.precompute_adjacency(),
                          g_1.precompute_adjacency()), "adjacency differs")
    _check(g_m.checksum_branching() == g_1.checksum_branching(),
           "branching differs")
    _check(np.array_equal(g_m._debloom.cfp, g_1._debloom.cfp),
           "debloom cFP set differs")
    ug_m, ug_1 = g_m.unitig_graph(), g_1.unitig_graph()
    _check(sorted(ug_m.sequences) == sorted(ug_1.sequences),
           "unitigs differ")
    s_m, s_1 = g_m.simplify(), g_1.simplify()
    _check(np.array_equal(g_m.node_state, g_1.node_state),
           "simplify differs")
    c_m, _ = g_m.contigs(traversal="monument")
    c_1, _ = g_1.contigs(traversal="monument")
    _check(sorted(c_m) == sorted(c_1), "Monument contigs differ")
    return {"nb_solid": int(len(res_1.solid_counts)),
            "nb_unitigs": int(ug_1.nb_unitigs),
            "tips": s_1.tips_removed, "nb_contigs": len(c_1)}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def card_lines() -> list[str]:
    """``name, power limit`` of each GPU as nvidia-smi reports it."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()


def require_gpu(n_devices: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX's first device is "
                 f"{devs[0].platform}); refusing to run")
    if len(devs) < n_devices:
        sys.exit(f"chip_smoke: need {n_devices} GPUs, JAX sees {len(devs)}")
    return devs


def require_native() -> None:
    from gatb_core_tpu import native

    if not native.available():
        sys.exit("chip_smoke: the native FASTA parser is unavailable:\n"
                 f"{native.build_error()}")


def run_phases(work: str, seed: int, four_cards: bool, card: str):
    """Every phase in order; returns (summary, wall seconds, recorder)."""
    rec = Recorder()
    t0 = time.time()
    bank, reads = rec.run("bank", phase_bank, work, seed)
    summary = {"card": card, "nb_reads": int(len(reads))}
    if four_cards:
        summary.update(rec.run("four_cards", phase_four_cards, bank))
    else:
        from gatb_core_tpu.storage.hdf5 import HAVE_H5PY

        # HDF5 when h5py is installed, else the numpy-only file backend
        out = os.path.join(work, "graph.h5" if HAVE_H5PY else "graph")
        print(f"storage: {'HDF5' if HAVE_H5PY else 'file backend'}",
              flush=True)
        graph = rec.run("dbgh5", phase_dbgh5, bank, out)
        summary["nb_device_programs"] = graph.storage.group(
            "configuration").get_property("nb_device_programs")
        chk = rec.run("check", phase_check, graph, reads)
        solid_words = chk.pop("solid_words")
        summary.update(chk)
        summary.update(rec.run("assembly", phase_assembly, graph,
                               solid_words))
        graph.storage.close()
        summary.update(rec.run("k63", phase_k63, bank, reads))
    return summary, time.time() - t0, rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--work-dir", default=None,
                    help="scratch directory for the bank and the graph "
                         "(default: a temporary directory, removed at exit)")
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    args = ap.parse_args(argv)

    from gatb_core_tpu.system.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    devs = require_gpu(4 if args.four_cards else 1)
    cards = card_lines()
    for line in cards:
        print(f"card: {line}", flush=True)
    card = cards[0]
    print(f"compile cache: {cache}", flush=True)
    require_native()
    with tempfile.TemporaryDirectory(prefix="chip_smoke-") as tmp:
        work = args.work_dir or tmp
        os.makedirs(work, exist_ok=True)
        summary, wall, rec = run_phases(work, args.seed, args.four_cards,
                                        card)
    summary["wall_s"] = round(wall, 3)
    summary["compile_s"] = round(rec.compile_s, 3)
    summary["compile_share"] = round(rec.compile_s / wall, 4)
    summary["peak_bytes_in_use"] = [
        d.memory_stats().get("peak_bytes_in_use") for d in devs[
            :4 if args.four_cards else 1]]
    print(f"summary ({card}): {json.dumps(summary, default=str)}",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
