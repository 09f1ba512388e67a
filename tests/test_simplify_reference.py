"""Whole-genome simplify conformance vs the reference LIBRARY
(VERDICT r2 item 6): our Simplifications must reproduce the surviving
kmer set of GraphUnitigs::simplify — the reference's only "modern"
simplify (plain Graph::simplifyPathDelete exits; GraphUnitigs.cpp:2010).

Driven through tools_dev/ref_simplify_harness.cpp, compiled on demand
against .ref_build/lib/Release/libgatbcore.a. The comparison unit is the
CANONICAL SURVIVING KMER SET (unitig splits regroup after deletions, so
sequences aren't directly comparable; the kmer set is).

Semantics these tests pin down (all reproduced in
debruijn/simplifications.py):
  - simplePathMeanAbundance's inflated chain mean (coverage counts nk
    kmers, seqLength counts nk-1 extensions)
  - getMeanAbundanceOfNeighbors' structure: entry-extremity edges only,
    own-chain counted once, nan on a zero-contribution branching node
  - EC: OR of the two RCTC directions, behind-branching + doubly-
    connected candidacy, single-kmer paths skipped
  - bulges: at most ONE deletion per (branching node, direction) per
    pass (the break at Simplifications.cpp:1552), HMCP with int-
    truncated chain abundances and the MAX_DEPTH-discards-found quirk
  - the schedule's loop counters see the reference's buggy dup
    accounting (multi-kmer deletions never count), so bulge/EC loops
    run exactly 3 passes

reads1 at a=1 is a tie-fest (everything coverage 1): tips and EC are
still byte-exact; bulges differ only in WHICH of two equal-coverage
twins dies (the reference breaks ties on ITS internal unitig ids). On
realistic coverage the decisions are tie-free and the full schedule is
byte-exact — the whole-genome test asserts exact set equality.
"""

import os
import subprocess

import numpy as np
import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIB = os.path.join(HERE, ".ref_build", "lib", "Release",
                       "libgatbcore.a")
HARNESS_SRC = os.path.join(HERE, "tools_dev", "ref_simplify_harness.cpp")
HARNESS_BIN = os.path.join(HERE, ".ref_build", "ref_simplify_harness")

pytestmark = pytest.mark.skipif(
    not os.path.exists(REF_LIB),
    reason="reference library not built (.ref_build)")

CODE = {"A": 0, "C": 1, "T": 2, "G": 3}
RC = {0: 2, 1: 3, 2: 0, 3: 1}


def _kmer_set(seqs, k):
    out = set()
    for seq in seqs:
        for i in range(len(seq) - k + 1):
            v = 0
            for c in seq[i:i + k]:
                v = (v << 2) | CODE[c]
            r, x = 0, v
            for _ in range(k):
                r = (r << 2) | RC[x & 3]
                x >>= 2
            out.add(min(v, r))
    return out


def _harness():
    if not os.path.exists(HARNESS_BIN) or \
            os.path.getmtime(HARNESS_BIN) < os.path.getmtime(HARNESS_SRC):
        cmd = ["c++", "-std=c++11", "-O2", "-msse2", "-msse4.2",
               "-mpopcnt", "-DINT128_FOUND", "-DNDEBUG",
               "-D_FILE_OFFSET_BITS=64", "-D_GNU_SOURCE",
               "-D_LARGEFILE64_SOURCE", "-D_LARGEFILE_SOURCE",
               "-Wno-invalid-offsetof",
               "-I" + os.path.join(HERE, ".ref_build", "include"),
               "-I" + os.path.join(HERE, ".ref_build", "include",
                                   "Release"),
               "-I/root/reference/gatb-core/src",
               "-I/root/reference/gatb-core/thirdparty",
               HARNESS_SRC, "-o", HARNESS_BIN, REF_LIB,
               os.path.join(HERE, ".ref_build", "lib", "Release",
                            "libhdf5.a"),
               "-ldl", "-lpthread", "-lz", "-lm"]
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    return HARNESS_BIN


def _ref_surviving(fasta, k, amin, ops):
    out = subprocess.run([_harness(), fasta, str(k), str(amin), ops],
                         capture_output=True, text=True, timeout=1800,
                         cwd=os.path.dirname(fasta))
    assert out.returncode == 0, out.stderr[-2000:]
    return [ln.split()[0] for ln in out.stdout.splitlines()
            if ln and ln[0] in "ACGT"]


def _our_surviving(fasta, k, amin, **simplify_kw):
    from gatb_core_tpu.debruijn.graph import Graph
    from gatb_core_tpu.debruijn.simplifications import Simplifications
    from gatb_core_tpu.ops.kmer_ops import kmers_to_py

    g = Graph.create(fasta, kmer_size=k, abundance_min=amin,
                     build_branching=False, mphf_kind="none",
                     debloom_kind="none", repartition=False)
    Simplifications(g).simplify(**simplify_kw)
    live = ~(g.node_state & 1).astype(bool)
    return set(kmers_to_py(g.solid_limbs[live]))


def _write_reads(path, genome_len, cov=30, rl=100, err=0.005, seed=42):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    nts = np.frombuffer(b"ACTG", np.uint8)
    n_reads = genome_len * cov // rl
    with open(path, "wb") as f:
        for i in range(n_reads):
            s = int(rng.integers(0, genome_len - rl))
            r = genome[s:s + rl].copy()
            m = rng.random(rl) < err
            r[m] = (r[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
            f.write(b">r%d\n" % i + nts[r].tobytes() + b"\n")


def test_simplify_whole_genome_exact(tmp_path):
    """Full simplify schedule on a 20 kbp genome at 30x with 0.5%
    errors: surviving canonical kmer sets EQUAL the reference
    library's."""
    fasta = str(tmp_path / "wg.fa")
    _write_reads(fasta, 20_000)
    ref = _kmer_set(_ref_surviving(fasta, 21, 2, "all"), 21)
    ours = _our_surviving(fasta, 21, 2)
    assert ours == ref
    assert len(ref) > 15_000  # non-vacuous


@pytest.mark.skipif(not os.environ.get("GATB_SLOW_TESTS"),
                    reason="slow (set GATB_SLOW_TESTS=1)")
@pytest.mark.parametrize("op,kw", [
    ("tips", dict(do_bulges=False, do_ec=False)),
    ("ec", dict(do_tips=False, do_bulges=False)),
])
def test_simplify_reads1_per_op_exact(test_db, tmp_path, op, kw):
    """Tips-only and EC-only runs on the reference's own reads1 fixture
    at a=1 (the pathological all-coverage-1 graph): byte-exact surviving
    kmer sets. (Bulges on this fixture differ only in which of two
    equal-coverage twins dies — tie order rides the reference's internal
    unitig numbering.)"""
    import shutil

    fasta = str(tmp_path / "reads1.fa")
    shutil.copy(f"{test_db}/reads1.fa", fasta)
    ref = _kmer_set(_ref_surviving(fasta, 21, 1, op), 21)
    ours = _our_surviving(fasta, 21, 1, **kw)
    assert ours == ref


@pytest.mark.skipif(not os.environ.get("GATB_SLOW_TESTS"),
                    reason="slow (set GATB_SLOW_TESTS=1)")
def test_simplify_reads1_full_near_exact(test_db, tmp_path):
    """Full schedule on reads1 a=1: equal surviving-set SIZES up to the
    twin-tie ambiguity (< 1% of kmers on this adversarial fixture)."""
    import shutil

    fasta = str(tmp_path / "reads1.fa")
    shutil.copy(f"{test_db}/reads1.fa", fasta)
    ref = _kmer_set(_ref_surviving(fasta, 21, 1, "all"), 21)
    ours = _our_surviving(fasta, 21, 1)
    assert abs(len(ours) - len(ref)) <= 20
    assert len(ours - ref) < 0.01 * len(ref)
    assert len(ref - ours) < 0.01 * len(ref)


@pytest.mark.skipif(not os.environ.get("GATB_SLOW_TESTS"),
                    reason="slow: 600k solid kmers (set GATB_SLOW_TESTS=1)")
def test_simplify_reads3_scale(test_db):
    """Real-read scale (reads3: 601,710 solid kmers at k=21 a=2, 15,908
    unitigs): full simplify schedule within 0.5% of the reference
    library's surviving kmer set, both directions (measured 2026-08-20:
    ours 548,294 vs ref 548,968 survivors; diff 1081/1755 — equal-
    coverage tie order and the reference's cached-non-simple-node
    iteration in later passes are not reproducible bit-for-bit).
    Wall-clock: 32 s on the 2-core host (r4 incremental recompaction +
    lazy sequence emission — was 505 s in r3)."""
    fasta = _gunzip(test_db)
    ref = _kmer_set(_ref_surviving(fasta, 21, 2, "all"), 21)
    ours = _our_surviving(fasta, 21, 2)
    assert len(ours - ref) < 0.005 * len(ref)
    assert len(ref - ours) < 0.005 * len(ref)
    assert abs(len(ours) - len(ref)) < 0.005 * len(ref)


def _gunzip(test_db):
    import gzip
    import shutil
    import tempfile

    out = os.path.join(tempfile.gettempdir(), "gatb_reads3.fa")
    if not os.path.exists(out):
        with gzip.open(f"{test_db}/reads3.fa.gz", "rb") as fin, \
                open(out, "wb") as fout:
            shutil.copyfileobj(fin, fout)
    return out
