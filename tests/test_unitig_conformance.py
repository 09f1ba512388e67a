"""Unitig-set conformance vs the reference binary (SURVEY §4 implication b).

Goldens: sha256 over the sorted canonical unitig list with km:f: means,
produced by the reference's own BCALM2+bglue+LinkTigs pipeline
(GraphUnitigsTemplate<span>::create via a harness linking
.ref_build/lib/Release/libgatbcore.a; see BASELINE.md round-2 notes):

  reads1.fa      k=31 a=3  ->  13 unitigs
  reads1.fa      k=21 a=1  -> 459 unitigs
  reads1.fa      k=63 a=2  ->  21 unitigs
  sample.fastq   k=21 a=1  ->   7 unitigs

Equality is set-equality modulo reverse complement and renumbering, PLUS
per-unitig mean abundance (km:f:%.1f) — the exact comparison the reference
emits in its FASTA headers (bcalm2/bglue_algo.cpp output).
"""

import hashlib

import pytest

from gatb_core_tpu.debruijn.graph import Graph

GOLDENS = {
    # name: (bank, k, amin, n_unitigs, sha16)
    "reads1_k31_a3": ("reads1.fa", 31, 3, 13, "5ca010ea06f6c3f3"),
    "reads1_k21_a1": ("reads1.fa", 21, 1, 459, "0059b837ade588df"),
    "reads1_k63_a2": ("reads1.fa", 63, 2, 21, "e9234362d51e09b0"),
    "sample_fq_k21_a1": ("sample.fastq", 21, 1, 7, "7810f566853f4e12"),
}

_RC = str.maketrans("ACGT", "TGCA")


def _canon(s: str, k: int | None = None) -> str:
    """RC-canonical unitig string; CIRCULAR unitigs (first k-1 == last
    k-1 chars — the wrap overlap) are additionally rotation-normalized:
    the reference's bcalm and our cycle-cut pick different (both valid)
    rotations of the same kmer cycle."""
    rc = s[::-1].translate(_RC)
    if k is not None and len(s) > k and s[:k - 1] == s[-(k - 1):]:
        core = s[:len(s) - (k - 1)]
        best = None
        for c in (core, core[::-1].translate(_RC)):
            for i in range(len(c)):
                r = c[i:] + c[:i]
                if best is None or r < best:
                    best = r
        return best + best[:k - 1]
    return min(s, rc)


def _blob(pairs: dict) -> str:
    return hashlib.sha256(
        "\n".join(f"{s} {pairs[s]:.1f}" for s in sorted(pairs))
        .encode()).hexdigest()[:16]


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_unitig_set_vs_reference_binary(name, test_db):
    bank, k, amin, n_exp, sha_exp = GOLDENS[name]
    g = Graph.create(f"{test_db}/{bank}", kmer_size=k, abundance_min=amin,
                     build_branching=False, mphf_kind="none",
                     debloom_kind="none", repartition=False)
    ug = g.unitig_graph()
    pairs = {_canon(s): round(float(m), 1)
             for s, m in zip(ug.sequences, ug.mean_abundance)}
    assert len(pairs) == n_exp
    assert _blob(pairs) == sha_exp


@pytest.mark.skipif(not __import__("os").environ.get("GATB_SLOW_TESTS"),
                    reason="slow: 4.9M kmers (set GATB_SLOW_TESTS=1)")
def test_unitig_set_reads3_scale(test_db):
    """4.9M-kmer scale: 15,908 unitigs, set + km:f equality vs the
    reference pipeline (rotation-normalized: reads3 contains tandem-
    repeat cycles emitted at different — equally valid — rotations)."""
    g = Graph.create(f"{test_db}/reads3.fa.gz", kmer_size=21,
                     abundance_min=2, batch_reads=4096,
                     build_branching=False, mphf_kind="none",
                     debloom_kind="none", repartition=False)
    ug = g.unitig_graph()
    pairs = {_canon(s, 21): round(float(m), 1)
             for s, m in zip(ug.sequences, ug.mean_abundance)}
    assert len(pairs) == 15908
    assert _blob(pairs) == "0da5b1b413d40434"
