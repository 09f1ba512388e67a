"""Configuration plan + repartitor tests."""

import numpy as np
import pytest

from gatb_core_tpu.bank.fasta import BankStrings
from gatb_core_tpu.kmer.configuration import compute_plan, kmer_type_size
from gatb_core_tpu.kmer.repartition import (
    compute_distrib, build_repartitor, Repartitor,
)


def test_type_sizes():
    assert kmer_type_size(31) == 8
    assert kmer_type_size(63) == 16
    assert kmer_type_size(127) == 32


def test_plan_small_bank():
    cfg = compute_plan(estimate_seq_nb=100, estimate_seq_total_size=10000,
                       estimate_seq_max_size=150, kmer_size=31,
                       max_memory_mb=5000, nb_cores=4)
    assert cfg.nb_passes == 1
    assert cfg.nb_partitions >= 1
    assert cfg.kmers_nb == (100 - 31 + 1) * 100
    assert cfg.volume_mb == 1  # tiny files fix


def test_plan_big_bank_partitions():
    # 1B kmers of 8 bytes = ~7.6 GB volume; with 1GB memory budget it must
    # split into multiple partitions
    cfg = compute_plan(estimate_seq_nb=10_000_000,
                       estimate_seq_total_size=10_000_000 * 150,
                       estimate_seq_max_size=150, kmer_size=31,
                       max_memory_mb=1000, nb_cores=8)
    assert cfg.nb_partitions > 1
    # partitions rounded to a multiple of the parallelism
    assert cfg.nb_partitions % cfg.nb_partitions_in_parallel == 0


def test_plan_disk_limit_forces_passes():
    cfg = compute_plan(estimate_seq_nb=10_000_000,
                       estimate_seq_total_size=10_000_000 * 150,
                       estimate_seq_max_size=150, kmer_size=31,
                       max_memory_mb=5000, max_disk_space_mb=500,
                       nb_cores=4)
    assert cfg.nb_passes > 1


def test_plan_empty_bank_raises():
    with pytest.raises(ValueError):
        compute_plan(0, 0, 0, 31)


def test_compute_distrib_balance():
    rng = np.random.default_rng(0)
    # power-law-ish bin sizes
    sizes = (rng.pareto(1.5, size=4096) * 100).astype(np.int64)
    table = compute_distrib(sizes, 8)
    assert table.max() < 8
    loads = np.zeros(8, np.int64)
    np.add.at(loads, table, sizes)
    # greedy packing: max/min load ratio should be close to 1
    assert loads.max() <= loads.min() * 1.05 + sizes.max()


def test_compute_distrib_largest_first():
    sizes = np.array([5, 100, 1, 50])
    table = compute_distrib(sizes, 2)
    # largest (idx 1) goes to partition 0, next (idx 3) to partition 1
    assert table[1] == 0
    assert table[3] == 1


def test_repartitor_roundtrip(tmp_path):
    from gatb_core_tpu.storage.hdf5 import Storage

    seqs = ["ACGGTCATCAATGCCGTAAGGCTAGCTTACGGACGGTCAT" * 3] * 5
    rep = build_repartitor(BankStrings(*seqs), kmer_size=15,
                           nb_partitions=4, minimizer_size=8,
                           batch_reads=8, batch_len=128)
    assert rep.table.shape == (4 ** 8,)
    assert rep.table.max() < 4
    with Storage(str(tmp_path / "r.h5"), "w") as st:
        rep.save(st)
        rep2 = Repartitor.load(st)
    assert (rep2.table == rep.table).all()
    assert rep2.nb_partitions == 4


def test_bank_cache_pass_reuse_exact():
    """Multi-pass counting with the device-resident bank cache must equal
    the uncached run and the ground truth (r4: later passes dispatch off
    pass 0's staged arrays)."""
    import numpy as np

    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import SortingCount, CountConfig
    from gatb_core_tpu.kmer.model import count_kmers_py

    rng = np.random.default_rng(3)
    genome = "".join(rng.choice(list("ACGT"), size=1200))
    reads = [genome[s:s + 100] for s in rng.integers(0, 1100, size=150)]
    base = dict(kmer_size=21, abundance_min=1, nb_passes=3,
                batch_reads=32, batch_len=128, superbatch_rows=1 << 12)
    r1 = SortingCount(CountConfig(**base)).execute(BankStrings(*reads))
    r2 = SortingCount(CountConfig(**base, bank_cache_bytes=0)) \
        .execute(BankStrings(*reads))
    assert (r1.solid_kmers == r2.solid_kmers).all()
    assert (r1.solid_counts == r2.solid_counts).all()
    assert r1.as_dict() == count_kmers_py(reads, 21, abundance_min=1)


def test_optimistic_replan_exact():
    """A too-small table budget must trigger the transactional pass
    re-plan (counting._RePlan -> doubled passes) with an exact result."""
    import numpy as np

    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import SortingCount, CountConfig
    from gatb_core_tpu.kmer.model import count_kmers_py

    rng = np.random.default_rng(4)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    reads = [genome[s:s + 100] for s in rng.integers(0, 2900, size=120)]
    cfg = CountConfig(kmer_size=21, abundance_min=1, nb_passes=1,
                      batch_reads=32, batch_len=128,
                      superbatch_rows=1 << 12,
                      table_budget_bytes=1)   # force the re-plan
    res = SortingCount(cfg).execute(BankStrings(*reads))
    assert res.info["nb_passes_effective"] > 1   # the re-plan fired
    assert res.as_dict() == count_kmers_py(reads, 21, abundance_min=1)


def test_carry_accumulator_mode_exact():
    """The opt-in carry-accumulator path (fold-into-dispatch, kept for
    multi-chip parity) must stay exact, multi-pass and re-plan included."""
    import numpy as np

    from gatb_core_tpu.bank.fasta import BankStrings
    from gatb_core_tpu.kmer.counting import SortingCount, CountConfig
    from gatb_core_tpu.kmer.model import count_kmers_py

    rng = np.random.default_rng(9)
    genome = "".join(rng.choice(list("ACGT"), size=2500))
    reads = [genome[s:s + 100] for s in rng.integers(0, 2400, size=140)]
    for passes in (1, 3):
        cfg = CountConfig(kmer_size=21, abundance_min=1,
                          nb_passes=passes, batch_reads=32,
                          batch_len=128, superbatch_rows=1 << 12,
                          carry_accumulator=True)
        res = SortingCount(cfg).execute(BankStrings(*reads))
        assert res.as_dict() == count_kmers_py(reads, 21, abundance_min=1)
    # forced re-plan through the carry guard
    cfg = CountConfig(kmer_size=21, abundance_min=1, nb_passes=1,
                      batch_reads=32, batch_len=128,
                      superbatch_rows=1 << 12, carry_accumulator=True,
                      table_budget_bytes=1)
    res = SortingCount(cfg).execute(BankStrings(*reads))
    assert res.info["nb_passes_effective"] > 1
    assert res.as_dict() == count_kmers_py(reads, 21, abundance_min=1)
