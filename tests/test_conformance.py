"""Conformance vs the reference dbgh5 binary (gatb-core v1.4.2).

Golden values below were produced by running the reference's own tool on
this machine (Release build at .ref_build/):

  dbgh5 -in test/db/reads1.fa -kmer-size 31 -abundance-min 3
  dbgh5 -in test/db/reads1.fa -kmer-size 63 -abundance-min 2
  dbgh5 -in test/db/reads3.fa.gz -kmer-size 21 -abundance-min 2  (slow)

This is the reference's functional non-regression format
(test/functional/test1/check/*.props, tools/dbgh5.cpp -check).
"""

import os

import pytest

from gatb_core_tpu.debruijn.graph import Graph

GOLDEN_READS1_K31_A3 = {
    "kmers_nb_valid": 91615,
    "kmers_nb_distinct": 86773,
    "kmers_nb_solid": 623,
    "kmers_nb_weak": 86150,
    "nb_branching": 24,
    "checksum_branching": "30eb72bc69eca0d3",
}

GOLDEN_READS1_K63_A2 = {
    "kmers_nb_valid": 88415,
    "kmers_nb_distinct": 84917,
    "kmers_nb_solid": 2281,
    "kmers_nb_weak": 82636,
    "nb_branching": 38,
    "checksum_branching": "b3ebca47e4682ee3.3fdb6572fb6e8445",
}

GOLDEN_READS1_K95_A1 = {
    "kmers_nb_valid": 85215,
    "kmers_nb_distinct": 82509,
    "kmers_nb_solid": 82509,
    "kmers_nb_weak": 0,
    "nb_branching": 239,
    "checksum_branching":
        "39594f031d350ada.7f627645472c88f0.9949f1148e076725",
}

GOLDEN_READS1_K127_A1 = {
    "kmers_nb_valid": 82015,
    "kmers_nb_distinct": 79781,
    "kmers_nb_solid": 79781,
    "nb_branching": 220,
    "checksum_branching": "b9e67d4435e050e.66d4dd190f971975."
                          "eb7dd4323bae8d93.eb861be547b64b5b",
}

GOLDEN_SAMPLE_FASTQ_K21_A1 = {
    "kmers_nb_valid": 101,
    "kmers_nb_distinct": 101,
    "kmers_nb_solid": 101,
    "nb_branching": 11,
    "checksum_branching": "89603aca8e3",
}

GOLDEN_MULTI_K31_A2 = {
    "kmers_nb_valid": 519811,
    "kmers_nb_distinct": 499496,
    "kmers_nb_solid": 16925,
    "kmers_nb_weak": 482571,
    "nb_branching": 307,
    "checksum_branching": "89556d06fd469514",
}

GOLDEN_READS3_K21_A2 = {
    "kmers_nb_valid": 4926295,
    "kmers_nb_distinct": 3971739,
    "kmers_nb_solid": 601710,
    "kmers_nb_weak": 3370029,
    "nb_branching": 21943,
    "checksum_branching": "5cceae3527b14d",
}


def _check(graph, golden):
    info = graph.get_info()
    for key, val in golden.items():
        assert str(info[key]) == str(val), (key, info[key], val)


def test_reads1_k31_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=31,
                         abundance_min=3)
    _check(graph, GOLDEN_READS1_K31_A3)


def test_reads1_k63_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=63,
                         abundance_min=2)
    _check(graph, GOLDEN_READS1_K63_A2)


@pytest.mark.slow
def test_reads1_k95_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=95,
                         abundance_min=1)
    _check(graph, GOLDEN_READS1_K95_A1)


@pytest.mark.slow
def test_reads1_k127_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=127,
                         abundance_min=1, batch_len=512)
    _check(graph, GOLDEN_READS1_K127_A1)


def test_sample_fastq_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/sample.fastq", kmer_size=21,
                         abundance_min=1)
    _check(graph, GOLDEN_SAMPLE_FASTQ_K21_A1)


def test_multifile_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa,{test_db}/reads2.fa",
                         kmer_size=31, abundance_min=2)
    _check(graph, GOLDEN_MULTI_K31_A2)


@pytest.mark.skipif(not os.environ.get("GATB_SLOW_TESTS"),
                    reason="slow: ~5M kmers on CPU (set GATB_SLOW_TESTS=1)")
def test_reads3_k21_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads3.fa.gz", kmer_size=21,
                         abundance_min=2, batch_reads=4096)
    _check(graph, GOLDEN_READS3_K21_A2)


# ---------------------------------------------------------------------------
# Postsolid byte-level conformance: the main (neighbor-coherent) Bloom and
# all three cascading-debloom blooms must be BYTE-IDENTICAL to the reference
# binary's .h5 output — this pins hash1, simplehash16 (incl. the LargeInt<1>
# 3-byte variant, LargeInt1.pri:190), cano2, the float32 sizing arithmetic
# (BloomAlgorithm.cpp:159-165, DebloomAlgorithm.cpp:497-520) and the cFP
# neighborhood semantics. Goldens = sha256 of the reference datasets
# produced by .ref_build dbgh5 on this machine (see module docstring).
# ---------------------------------------------------------------------------

GOLDEN_POSTSOLID_K31_A3 = {
    "bloom_sha": "5ba51a7fb21661a8", "bloom_bytes": 1494,
    "bloom_bits": 3759, "bloom_nbhash": 4, "nb_cfp": 38,
    "bloom2_sha": "7ad32120229e9bd4", "bloom2_bytes": 1053,
    "bloom3_sha": "841b41a785465465", "bloom3_bytes": 1051,
    "bloom4_sha": "241f676dc4eb5ac7", "bloom4_bytes": 1027,
    "t4_n": 0,
}

GOLDEN_POSTSOLID_K63_A2 = {
    "bloom_sha": "5c1a0596c8724514", "bloom_bytes": 2846,
    "bloom_bits": 14575, "bloom_nbhash": 4, "nb_cfp": 514,
    "bloom2_sha": "67ab039f9aab4c93", "bloom2_bytes": 1435,
    "bloom3_sha": "be7c3eeeb9893ab5", "bloom3_bytes": 1111,
    "bloom4_sha": "f48f6f0c7c602035", "bloom4_bytes": 1044,
    "t4_n": 0,
}


def _sha_bits(bloom, nbytes):
    import hashlib
    import numpy as np

    raw = np.asarray(bloom.words).view(np.uint8)[:nbytes]
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _check_postsolid(graph, golden):
    deb = graph._debloom
    assert deb is not None and deb.kind == "cascading"
    assert deb.bloom.size_bits == golden["bloom_bits"]
    assert deb.bloom.n_hash == golden["bloom_nbhash"]
    assert deb.nb_cfp == golden["nb_cfp"]
    assert _sha_bits(deb.bloom, golden["bloom_bytes"]) == golden["bloom_sha"]
    for i, b in enumerate(deb.cascade.blooms, start=2):
        assert _sha_bits(b, golden[f"bloom{i}_bytes"]) \
            == golden[f"bloom{i}_sha"], f"bloom{i}"
    assert len(deb.cascade.t4) == golden["t4_n"]


def test_postsolid_k31_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=31,
                         abundance_min=3)
    _check_postsolid(graph, GOLDEN_POSTSOLID_K31_A3)
    # bloom AND NOT cFP == exact membership on the traversal closure
    import numpy as np
    import jax.numpy as jnp
    from gatb_core_tpu.ops.neighbor_ops import neighbor_candidates

    cands = np.asarray(neighbor_candidates(
        jnp.asarray(graph.solid_limbs), 31)).reshape(-1, graph._w)
    assert (graph.contains(cands, mode="exact")
            == graph.contains(cands, mode="bloom_cfp")).all()


def test_postsolid_k63_vs_reference_binary(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=63,
                         abundance_min=2)
    _check_postsolid(graph, GOLDEN_POSTSOLID_K63_A2)
