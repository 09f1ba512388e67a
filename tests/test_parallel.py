"""Multi-chip counting tests on the virtual 8-device CPU mesh.

Checks SURVEY §4's implication (d): same outputs at 1 device vs N devices —
the all-to-all minimizer exchange must be result-invariant.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from gatb_core_tpu.ops.bitpack import ascii_to_codes_np
from gatb_core_tpu.parallel.mesh import make_mesh
from gatb_core_tpu.parallel.exchange import make_count_step, global_table
from gatb_core_tpu.kmer.model import count_kmers_py
from gatb_core_tpu.ops.kmer_ops import kmers_to_py


def _batch(seqs, B, L):
    codes = np.zeros((B, L), np.uint8)
    valid = np.zeros((B, L), bool)
    lengths = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        c, v = ascii_to_codes_np(np.frombuffer(s.encode(), np.uint8))
        codes[i, :len(s)] = c
        valid[i, :len(s)] = v
        lengths[i] = len(s)
    return codes, valid, lengths


@pytest.mark.parametrize("ndev", [2, 8])
def test_sharded_count_equals_reference(ndev):
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(42)
    k, m = 21, 10
    B, L = 64, 96
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(k, L))))
            for _ in range(B - 8)]
    seqs += seqs[:6]  # duplicates
    seqs.append("N" * 40)  # invalid
    seqs.append("ACGT")   # too short
    codes, valid, lengths = _batch(seqs, B, L)

    mesh = make_mesh(ndev)
    step = make_count_step(mesh, k, m)
    shards = step(jnp.asarray(codes), jnp.asarray(valid),
                  jnp.asarray(lengths), jnp.int32(0))
    gk, gc = global_table(shards, ndev)

    exp = count_kmers_py(seqs, k)
    got = dict(zip(kmers_to_py(gk), gc.tolist()))
    assert got == exp


def test_overflow_is_exact():
    """Tiny capacity factor forces overflow; results must stay exact."""
    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    rng = np.random.default_rng(3)
    k = 15
    B, L = 32, 64
    # many copies of the same read -> one hot partition -> overflow
    base = "".join(rng.choice(list("ACGT"), size=60))
    seqs = [base] * (B - 2) + ["".join(rng.choice(list("ACGT"), size=60))
                               for _ in range(2)]
    codes, valid, lengths = _batch(seqs, B, L)
    mesh = make_mesh(ndev)
    step = make_count_step(mesh, k, 10, capacity_factor=0.25)
    shards = step(jnp.asarray(codes), jnp.asarray(valid),
                  jnp.asarray(lengths), jnp.int32(0))
    assert int(np.asarray(shards.n_overflowed).sum()) > 0
    gk, gc = global_table(shards, ndev)
    exp = count_kmers_py(seqs, k)
    got = dict(zip(kmers_to_py(gk), gc.tolist()))
    assert got == exp


# ---------------------------------------------------------------------------
# End-to-end multi-device driver (full bank, pass loop, repartitor)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ndev,nb_passes", [(8, 1), (4, 2)])
def test_distributed_full_bank_equals_single_device(test_db, ndev,
                                                    nb_passes):
    """Full-bank multi-device count == single-device golden on reads1.fa
    (VERDICT round-1 item 3: the production exchange driver)."""
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.parallel.exchange import count_kmers_distributed
    from gatb_core_tpu.kmer.counting import count_kmers

    mesh = make_mesh(ndev)
    res = count_kmers_distributed(f"{test_db}/reads1.fa", mesh,
                                  kmer_size=31, abundance_min=3,
                                  nb_passes=nb_passes)
    ref = count_kmers(f"{test_db}/reads1.fa", kmer_size=31, abundance_min=3)
    assert res.info["kmers_nb_valid"] == ref.info["kmers_nb_valid"]
    assert res.info["kmers_nb_distinct"] == ref.info["kmers_nb_distinct"]
    assert (res.solid_kmers == ref.solid_kmers).all()
    assert (res.solid_counts == ref.solid_counts).all()


def test_distributed_overflow_exact():
    """Forced send-window overflow on the full driver stays exact."""
    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.parallel.exchange import count_kmers_distributed
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.model import count_kmers_py

    rng = np.random.default_rng(9)
    base = "".join(rng.choice(list("ACGT"), size=80))
    seqs = [base] * 40 + ["".join(rng.choice(list("ACGT"), size=80))
                          for _ in range(8)]
    mesh = make_mesh(ndev)
    res = count_kmers_distributed(BankStrings(*seqs), mesh, kmer_size=15,
                                  abundance_min=1,
                                  batch_reads_per_device=4,
                                  capacity_factor=0.25, repartitor=None)
    exp = count_kmers_py(seqs, 15, abundance_min=1)
    got = dict(zip(kmers_to_py(res.solid_kmers),
                   res.solid_counts.tolist()))
    assert got == exp


def test_sharded_count_with_repartitor():
    """Exchange with the greedy load-balanced repartition table."""
    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.kmer.repartition import build_repartitor
    from gatb_core_tpu.bank.fasta import BankStrings

    rng = np.random.default_rng(11)
    k, m = 21, 8
    B, L = 32, 96
    seqs = ["".join(rng.choice(list("ACGT"), size=int(rng.integers(k, L))))
            for _ in range(B)]
    rep = build_repartitor(BankStrings(*seqs), kmer_size=k, nb_partitions=ndev,
                           minimizer_size=m, batch_reads=8, batch_len=128)
    codes, valid, lengths = _batch(seqs, B, L)
    mesh = make_mesh(ndev)
    step = make_count_step(mesh, k, m, repartitor=rep)
    shards = step(jnp.asarray(codes), jnp.asarray(valid),
                  jnp.asarray(lengths), jnp.int32(0))
    gk, gc = global_table(shards, ndev)
    exp = count_kmers_py(seqs, k)
    got = dict(zip(kmers_to_py(gk), gc.tolist()))
    assert got == exp


# ---------------------------------------------------------------------------
# Production superbatch exchange driver (parallel/superbatch.py)
# ---------------------------------------------------------------------------


def test_superbatch_multi_dispatch_accumulates(test_db):
    """Tiny superbatch_rows forces MANY dispatches per pass; the
    device-resident accumulator must carry the table across them and the
    final result must equal the single-device golden."""
    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.parallel.superbatch import (
        count_kmers_distributed_superbatch)
    from gatb_core_tpu.kmer.counting import count_kmers

    mesh = make_mesh(ndev)
    res = count_kmers_distributed_superbatch(
        f"{test_db}/reads1.fa", mesh, kmer_size=31, abundance_min=3,
        batch_reads_per_device=16, superbatch_rows=1 << 14)
    ref = count_kmers(f"{test_db}/reads1.fa", kmer_size=31, abundance_min=3)
    assert res.info["kmers_nb_valid"] == ref.info["kmers_nb_valid"]
    assert res.info["kmers_nb_distinct"] == ref.info["kmers_nb_distinct"]
    assert (res.solid_kmers == ref.solid_kmers).all()
    assert (res.solid_counts == ref.solid_counts).all()


def test_superbatch_overflow_retry_exact():
    """Absurd capacity hints force every overflow class (local table,
    send window, accumulator); the transactional retry must converge and
    stay exact."""
    ndev = 4
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.parallel.superbatch import (
        count_kmers_distributed_superbatch)
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.model import count_kmers_py

    rng = np.random.default_rng(17)
    base = "".join(rng.choice(list("ACGT"), size=80))
    seqs = [base] * 30 + ["".join(rng.choice(list("ACGT"), size=80))
                          for _ in range(18)]
    mesh = make_mesh(ndev)
    res = count_kmers_distributed_superbatch(
        BankStrings(*seqs), mesh, kmer_size=15, abundance_min=1,
        batch_reads_per_device=4, capacity_factor=0.05,
        distinct_ratio_hint=0.001)
    exp = count_kmers_py(seqs, 15, abundance_min=1)
    got = dict(zip(kmers_to_py(res.solid_kmers), res.solid_counts.tolist()))
    assert got == exp


@pytest.mark.skipif(
    not __import__("os").environ.get("GATB_SLOW_TESTS"),
    reason="slow: ~1.2M distinct on the CPU mesh "
           "(set GATB_SLOW_TESTS=1)")
def test_distributed_million_distinct_with_skew():
    """>=1M-distinct multi-device equality (VERDICT r4 item 7): a
    repeat-heavy genome (25% = 60 copies of one 5 kb segment) skews the
    minimizer/range distribution, exercising send-window sizing and
    accumulator growth at a size where the skew actually bites; the
    distributed table must equal the single-device fold path
    key-by-key."""
    ndev = 8
    if len(jax.devices()) < ndev:
        pytest.skip("not enough devices")
    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import count_kmers
    from gatb_core_tpu.parallel.exchange import count_kmers_distributed

    rng = np.random.default_rng(17)
    repeat = "".join(rng.choice(list("ACGT"), size=5_000))
    uniq = "".join(rng.choice(list("ACGT"), size=1_200_000))
    genome = uniq + repeat * 60          # ~1.5 Mbp, 25% repeat content
    L = 100
    starts = rng.integers(0, len(genome) - L, size=45_000)
    reads = [genome[s:s + L] for s in starts]
    bank = BankStrings(*reads)

    mesh = make_mesh(ndev)
    res = count_kmers_distributed(bank, mesh, kmer_size=31,
                                  abundance_min=1, nb_passes=1)
    ref = count_kmers(bank, kmer_size=31, abundance_min=1)
    assert ref.info["kmers_nb_distinct"] >= 1_000_000
    assert res.info["kmers_nb_valid"] == ref.info["kmers_nb_valid"]
    assert (res.solid_kmers == ref.solid_kmers).all()
    assert (res.solid_counts == ref.solid_counts).all()
