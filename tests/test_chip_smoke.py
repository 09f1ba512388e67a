"""chip_smoke.py on the CPU at tiny size: its numpy oracle against the
dict model, its phase functions called directly, and its refusal to run
without a GPU. ``main()`` alone checks the device, so the phases run here
unchanged."""

import os

import numpy as np
import pytest

import chip_smoke as cs
from gatb_core_tpu.kmer.model import count_kmers_py


def _bank(tmp_path, seed=3, genome_len=6000, nb_reads=1200):
    return cs.phase_bank(str(tmp_path), seed, genome_len=genome_len,
                         nb_reads=nb_reads)


@pytest.mark.parametrize("k", [31, 63])
def test_oracle_matches_model(k):
    reads = cs.make_reads(3000, 300, 150, 0.01, seed=k)
    keys, counts, hist = cs.oracle_count(reads, k, abundance_min=2)
    seqs = ["".join("ACTG"[c] for c in r) for r in reads]
    exp = count_kmers_py(seqs, k, abundance_min=2)
    got = {}
    for row, c in zip(keys.tolist(), counts.tolist()):
        v = 0
        for word in row:
            v = (v << 64) | word
        got[v] = c
    assert got == exp
    assert hist.sum() == len(count_kmers_py(seqs, k))


def test_seq_kmers_skips_windows_across_sequences():
    seqs = ["ACGTACGTAC", "GGGCCCA", "ACG"]
    got = cs.seq_kmers(seqs, 5)
    exp = count_kmers_py(seqs, 5)
    assert len(got) == (10 - 4) + (7 - 4)
    assert sorted(set(got[:, 0].tolist())) == sorted(exp)


def test_nb_branching_oracle_on_a_fork():
    # two reads sharing a prefix then diverging: the shared k-mer at the
    # fork has out-degree 2
    seqs = ["AAAACCCCGTTT", "AAAACCCCGAAG"]
    keys = np.array(sorted(count_kmers_py(seqs, 5)), np.uint64)
    assert cs.oracle_nb_branching(keys, 5) >= 1


@pytest.mark.parametrize("out", ["g.h5", "g"], ids=["hdf5", "file"])
def test_phases_dbgh5_check_assembly(tmp_path, out):
    bank, reads = _bank(tmp_path)
    graph = cs.phase_dbgh5(bank, str(tmp_path / out),
                           extra=("-max-memory", "1", "-verbose", "0"))
    chk = cs.phase_check(graph, reads)
    solid = chk.pop("solid_words")
    assert chk["nb_solid"] == len(solid) > 0
    asm = cs.phase_assembly(graph, solid)
    assert asm["unitig_kmers"] == chk["nb_solid"]
    assert asm["nb_contigs"] >= 1
    graph.storage.close()


def test_phase_k63(tmp_path):
    bank, reads = _bank(tmp_path, seed=4, genome_len=3000, nb_reads=600)
    out = cs.phase_k63(bank, reads, superbatch_rows=1 << 16)
    assert out["nb_solid_k63"] > 0


def test_phase_four_cards_on_virtual_devices(tmp_path):
    bank, _ = _bank(tmp_path, seed=5, genome_len=4000, nb_reads=800)
    out = cs.phase_four_cards(bank, superbatch_rows=1 << 16)
    assert out["nb_solid"] > 0


def test_check_table_rejects_a_wrong_count():
    limbs = np.array([[0, 5], [0, 9]], np.uint32)
    keys = cs.limbs_to_words(limbs)
    cs.check_table(limbs, [3, 4], keys, np.array([3, 4]), "t")
    with pytest.raises(AssertionError):
        cs.check_table(limbs, [3, 5], keys, np.array([3, 4]), "t")


def test_main_refuses_the_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        cs.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_main_fails_without_the_package(tmp_path):
    """In a directory holding only the script it exits non-zero."""
    import shutil
    import subprocess
    import sys

    shutil.copy(cs.__file__, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
