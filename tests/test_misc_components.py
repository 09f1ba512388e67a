"""Tests for IterativeExtensions, BankBinary, TimeInfo/Progress,
properties, enums."""

import numpy as np
import pytest

from gatb_core_tpu.bank.fasta import BankStrings, BankFasta
from gatb_core_tpu.bank.binary import BankBinary, convert_bank
from gatb_core_tpu.debruijn.graph import Graph
from gatb_core_tpu.debruijn.iterative_extensions import IterativeExtensions
from gatb_core_tpu.misc.properties import Properties
from gatb_core_tpu.misc.time_info import TimeInfo
from gatb_core_tpu.misc.enums import (
    BloomKind, KmerSolidityKind, parse_enum, STR_KMER_SIZE,
)


def _rand(rng, n):
    return "".join(rng.choice(list("ACGT"), size=n))


class TestIterativeExtensions:
    def test_extend_linear(self):
        k = 15
        rng = np.random.default_rng(1)
        genome = _rand(rng, 200)
        reads = [genome[i:i + 60] for i in range(0, 140, 7)]
        graph = Graph.create(BankStrings(*reads), kmer_size=k,
                             abundance_min=1, batch_reads=32, batch_len=128,
                             build_branching=False)
        seed = genome[:k]
        res = IterativeExtensions(graph).extend(seed)
        # extends to the end of the covered region
        assert res.sequence.startswith(seed)
        assert genome.startswith(res.sequence[:len(genome)]) or \
            len(res.sequence) > k
        assert res.nb_nucleotides > 100

    def test_extend_to_target(self):
        k = 15
        rng = np.random.default_rng(2)
        genome = _rand(rng, 150)
        reads = [genome[i:i + 60] for i in range(0, 90, 5)]
        graph = Graph.create(BankStrings(*reads), kmer_size=k,
                             abundance_min=1, batch_reads=32, batch_len=128,
                             build_branching=False)
        res = IterativeExtensions(graph).extend(
            genome[:k], target=genome[50:50 + k])
        assert res.reached_target
        assert res.sequence == genome[:50 + k]

    def test_seed_not_in_graph(self):
        k = 15
        graph = Graph.create(BankStrings("ACGGTCATCAATGCCGT"), kmer_size=k,
                             abundance_min=1, batch_reads=4, batch_len=64,
                             build_branching=False)
        res = IterativeExtensions(graph).extend("T" * k)
        assert res.sequence == "T" * k
        assert res.nb_nucleotides == 0


class TestBankBinary:
    def test_roundtrip(self, tmp_path, test_db):
        src = BankFasta(f"{test_db}/reads1.fa")
        out = str(tmp_path / "b.bin")
        n = convert_bank(src, out)
        back = list(BankBinary(out))
        orig = list(src)
        assert len(back) == n == len(orig) == 100
        for got, exp in zip(back, orig):
            assert got.data == exp.data.upper()

    def test_n_becomes_a(self, tmp_path):
        out = str(tmp_path / "c.bin")
        convert_bank(BankStrings("ACGNACGT"), out)
        assert list(BankBinary(out))[0].data == "ACGAACGT"


class TestMisc:
    def test_properties_check(self):
        p = Properties()
        p.add(0, "root")
        p.add(1, "kmer_size", 31)
        p.add(1, "nb", 42)
        assert p.get("kmer_size") == "31"
        errors = p.check_against({"kmer_size": "31", "nb": "42"})
        assert errors == []
        errors = p.check_against({"kmer_size": "21", "missing": "1"})
        assert len(errors) == 2
        assert "<kmer_size>31</kmer_size>" in p.dump_xml()

    def test_time_info(self):
        ti = TimeInfo()
        with ti.section("phase1"):
            pass
        with ti.section("phase1"):
            pass
        props = ti.get_properties()
        assert "time.phase1" in props

    def test_enums(self):
        assert BloomKind.default() is BloomKind.CACHE
        assert KmerSolidityKind.default() is KmerSolidityKind.SUM
        assert parse_enum(BloomKind, "neighbor") is BloomKind.NEIGHBOR
        with pytest.raises(ValueError):
            parse_enum(BloomKind, "bogus")
        assert STR_KMER_SIZE == "-kmer-size"


class TestLeonBank:
    def test_leon_cli_and_bank(self, test_db, tmp_path):
        """leon CLI round trip + .leon file readable as a bank."""
        import subprocess, sys, os

        src = f"{test_db}/leon1.fastq"
        out = str(tmp_path / "l.leon")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.abspath(
                       os.path.join(os.path.dirname(__file__), "..")))
        r = subprocess.run(
            [sys.executable, "-m", "gatb_core_tpu.tools.leon", "-c",
             "-lossless",  # default is the reference's lossy qual mode
             "-file", src, "-kmer-size", "21", "-abundance", "1",
             "-out", out], capture_output=True, text=True, env=env,
            timeout=300)
        assert r.returncode == 0, r.stderr[-800:]
        dec = str(tmp_path / "l.fastq")
        r = subprocess.run(
            [sys.executable, "-m", "gatb_core_tpu.tools.leon", "-d",
             "-file", out, "-out", dec], capture_output=True, text=True,
            env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-800:]
        orig = [(s.comment, s.data, s.quality) for s in BankFasta(src)]
        back = [(s.comment, s.data, s.quality) for s in BankFasta(dec)]
        assert back == orig

        # .leon readable through the bank registry
        from gatb_core_tpu.bank.fasta import open_bank, BankLeon
        bank = open_bank(out)
        assert isinstance(bank, BankLeon)
        assert [s.data for s in bank] == [d for _, d, _ in orig]

    def test_bank_random(self):
        from gatb_core_tpu.bank.fasta import BankRandom
        bank = BankRandom(5, 40, seed=1)
        seqs = list(bank)
        assert len(seqs) == 5
        assert all(len(s.data) == 40 for s in seqs)
        assert set("".join(s.data for s in seqs)) <= set("ACGT")
        # deterministic
        assert [s.data for s in BankRandom(5, 40, seed=1)] == \
            [s.data for s in seqs]


class TestTopologyAndHistogram2D:
    def test_histogram2d(self):
        from gatb_core_tpu.kmer.histogram import Histogram2D
        h = Histogram2D(max_value=10)
        counts = np.array([[1, 2], [1, 2], [3, 0], [50, 4]])
        h.add_counts(counts)
        assert h.bins[1, 2] == 2
        assert h.bins[3, 0] == 1
        assert h.bins[10, 4] == 1  # clamped
        h2 = Histogram2D(max_value=10)
        h2.add_counts(np.array([[1, 2]]))
        h.merge(h2)
        assert h.bins[1, 2] == 3

    def test_dbgtopology_cli(self, test_db, tmp_path):
        import subprocess, sys, os

        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=os.path.abspath(
                       os.path.join(os.path.dirname(__file__), "..")))
        r = subprocess.run(
            [sys.executable, "-m", "gatb_core_tpu.tools.dbgtopology",
             "-in", f"{test_db}/reads1.fa", "-kmer-size", "31",
             "-abundance-min", "3"], capture_output=True, text=True,
            env=env, timeout=300)
        assert r.returncode == 0, r.stderr[-800:]
        assert "nodes: 623" in r.stdout
        # branching count must match the conformance golden (24)
        assert "branching (in!=1 or out!=1): 24" in r.stdout


# ---------------------------------------------------------------------------
# string utilities (tools/misc/impl/Stringify.hpp, Tokenizer.cpp,
# StringLine.hpp, XmlReader.cpp)
# ---------------------------------------------------------------------------


def test_stringify_and_tokenizer():
    from gatb_core_tpu.misc.strings import Stringify, TokenizerIterator

    assert Stringify.format("k=%d in %s", 31, "reads.fa") == "k=31 in reads.fa"
    it = TokenizerIterator("a,b;;c,", ",;")
    assert list(it) == ["a", "b", "c"]
    it.first()
    toks = []
    while not it.is_done():
        toks.append(it.item())
        it.next()
    assert toks == ["a", "b", "c"]


def test_string_line_wrap():
    from gatb_core_tpu.misc.strings import StringLine

    out = StringLine.format("one two three four five six", width=12)
    assert all(len(line) <= 12 for line in out.splitlines())
    assert out.replace("\n", " ") == "one two three four five six"


def test_xml_reader_events():
    from gatb_core_tpu.misc.strings import XmlReader

    xml = '<?xml version="1.0"?><config a="1 &amp; 2"><kmer_size>31' \
          '</kmer_size><empty/></config>'
    ev = XmlReader(xml).read()
    kinds = [(e.kind, e.name) for e in ev]
    assert ("open", "config") in kinds
    assert ("open", "kmer_size") in kinds
    assert ("close", "kmer_size") in kinds
    assert ("open", "empty") in kinds and ("close", "empty") in kinds
    attr = [e for e in ev if e.kind == "attribute"][0]
    assert attr.name == "a" and attr.value == "1 & 2"
    text = [e for e in ev if e.kind == "text"][0]
    assert text.name == "31"


def test_bag_partition(tmp_path):
    from gatb_core_tpu.collections.containers import BagPartition

    bp = BagPartition(str(tmp_path / "parts"), 4, cache_size=2)
    for i in range(20):
        bp.insert(i % 4, i * 10)
    bp.close()
    for p in range(4):
        vals = list(bp.iterator(p))
        assert vals == [i * 10 for i in range(20) if i % 4 == p]


def test_hash16_memory_budget():
    from gatb_core_tpu.collections.containers import Hash16

    h = Hash16(max_memory_mb=1)
    assert not h.is_full
    # budget = 1MB/16B = 65536 entries
    for i in range(65536):
        h.insert(i)
    assert h.is_full


def test_algorithm_base_contract():
    from gatb_core_tpu.misc.algorithm import Algorithm

    class Summer(Algorithm):
        def execute(self):
            with self.time_info.section("1.sum"):
                total = sum(range(1000))
            self.info["total"] = total
            return total

    a = Summer("summer")
    assert a.run() == 499500
    info = a.get_info()
    assert info["total"] == 499500
    assert "exec_time" in info and "time.execute" in info
    assert "summer" in a.get_properties().dump_raw()


def test_storage_byte_streams(tmp_path):
    from gatb_core_tpu.storage.hdf5 import Storage

    with Storage(str(tmp_path / "s.h5"), "w") as st:
        g = st.group("minimizers")
        with g.ostream("minimRepart") as os_:
            os_.write(b"\x12\x34")
            os_.write(bytes(range(16)))
        is_ = g.istream("minimRepart")
        assert is_.read(2) == b"\x12\x34"
        assert is_.tell() == 2
        assert is_.read() == bytes(range(16))
        is_.seek(0)
        assert is_.read(1) == b"\x12"


def test_host_and_library_info():
    from gatb_core_tpu.system.info import host_info, library_info

    h = host_info()
    assert h["cnb_cores"] >= 1 and "chost_name" in h
    li = library_info()
    assert li["version"] and "jax" in li and "build_system" in li
