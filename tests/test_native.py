"""Native C++ host runtime (native/fastx.cpp): equivalence vs the pure-Python
parser/batcher on the reference-bundled fixtures.

The native path feeds the counting driver (kmer/counting.py) with the exact
same (codes, valid, lengths) batches as _BatchBuilder; these tests pin that
bit-equivalence (including FASTQ, gzip, wrapped FASTA, N handling, and long
reads split with k-1 overlap).
"""

import os

import numpy as np
import pytest

from gatb_core_tpu.bank.fasta import BankFasta
from gatb_core_tpu.kmer.counting import _BatchBuilder

native = pytest.importorskip("gatb_core_tpu.native")

if not native.available():
    pytest.skip("native toolchain unavailable", allow_module_level=True)


def _py_batches(path, k, B, L):
    builder = _BatchBuilder(k, B, L)
    out = []
    for seq in BankFasta(path):
        out.extend(builder.add(seq.data))
    if builder.row:
        out.append(builder.flush())
    return out


CASES = [
    ("reads1.fa", 31),
    ("sample.fastq", 21),
    ("sample.fastq.gz", 21),
    ("reads1.fa.gz", 31),
]


@pytest.mark.parametrize("name,k", CASES)
def test_native_batches_match_python(test_db, name, k):
    path = os.path.join(test_db, name)
    B, L = 64, 128
    pyb = _py_batches(path, k, B, L)
    natb = list(native.NativeBatcher(path, k, B, L))
    assert len(pyb) == len(natb)
    for (pc, pv, pl, pr), (nc, nv, nl, nr) in zip(pyb, natb):
        assert pr == nr
        for r in range(pr):
            m = pl[r]
            assert nl[r] == m
            assert np.array_equal(pc[r, :m], nc[r, :m])
            assert np.array_equal(pv[r, :m], nv[r, :m])


@pytest.mark.parametrize("name,k", CASES)
def test_native_seq_reader_matches_python(test_db, name, k):
    path = os.path.join(test_db, name)
    seqs_py = [s.data for s in BankFasta(path)]
    seqs_nat = list(native.NativeSeqReader(path, initial_cap=32))
    assert seqs_py == seqs_nat


def test_long_reads_split_with_overlap(tmp_path):
    # long wrapped FASTA read + Ns + lowercase + short read
    p = tmp_path / "long.fa"
    p.write_text(">a\n" + "ACGT" * 200 + "\n" + "TTNNtt" * 50 + "\n"
                 + ">b\nAC\n>c empty\n\n>d\n" + "G" * 3000 + "\n")
    k, B, L = 15, 8, 96
    pyb = _py_batches(str(p), k, B, L)
    natb = list(native.NativeBatcher(str(p), k, B, L))
    assert len(pyb) == len(natb)
    for (pc, pv, pl, pr), (nc, nv, nl, nr) in zip(pyb, natb):
        assert pr == nr
        assert np.array_equal(pl[:pr], nl[:nr])
        for r in range(pr):
            m = pl[r]
            assert np.array_equal(pc[r, :m], nc[r, :m])
            assert np.array_equal(pv[r, :m], nv[r, :m])


def test_native_stats(test_db):
    path = os.path.join(test_db, "reads1.fa")
    nat = native.NativeBatcher(path, 31, 64, 128)
    list(nat)
    nb, total = nat.stats()
    seqs = [s.data for s in BankFasta(path)]
    assert nb == len(seqs)
    assert total == sum(len(s) for s in seqs)


def test_counting_native_vs_python_path(test_db):
    from gatb_core_tpu.kmer.counting import count_kmers

    path = os.path.join(test_db, "reads1.fa")
    r_nat = count_kmers(path, kmer_size=25, abundance_min=2)
    os.environ["GATB_NO_NATIVE"] = "1"
    try:
        r_py = count_kmers(path, kmer_size=25, abundance_min=2)
    finally:
        del os.environ["GATB_NO_NATIVE"]
    assert np.array_equal(r_nat.solid_kmers, r_py.solid_kmers)
    assert np.array_equal(r_nat.solid_counts, r_py.solid_counts)
    assert r_nat.info["kmers_nb_valid"] == r_py.info["kmers_nb_valid"]
    assert r_nat.info["sequences_number"] == r_py.info["sequences_number"]
    assert r_nat.info["sequences_size"] == r_py.info["sequences_size"]


def test_so_name_follows_the_source(tmp_path, monkeypatch):
    """The built library is named after the source's hash, so an edited
    source is rebuilt even where file times cannot be trusted."""
    src = tmp_path / "fastx.cpp"
    src.write_text("int a;\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    first = native._so_path()
    src.write_text("int b;\n")
    assert native._so_path() != first
    assert os.path.basename(first).startswith("_fastx-")


def test_build_failure_keeps_the_compiler_message(tmp_path, monkeypatch):
    src = tmp_path / "broken.cpp"
    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setattr(native, "_build_error", None)
    assert not native._build(str(tmp_path / "_fastx-x.so"))
    err = native.build_error()
    assert "g++" in err and "broken.cpp" in err
    assert not os.path.exists(tmp_path / "_fastx-x.so")
