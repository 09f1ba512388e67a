"""Aux CLI tools: dbgcheck, bankgen, kmer_checksum, LinearCounter.

Reference: tools/dbgcheck.cpp, tools/bankgen.cpp, tools/KmerChecksum.cpp,
kmer/impl/LinearCounter.cpp (non-default build tools / experimental
estimator).
"""

import io
import os
import struct
from contextlib import redirect_stdout

import numpy as np
import pytest

from gatb_core_tpu.tools.dbgcheck import check_graph, largeint_hex
from gatb_core_tpu.tools.bankgen import main as bankgen_main
from gatb_core_tpu.tools.kmer_checksum import main as checksum_main
from gatb_core_tpu.bank.fasta import BankFasta
from gatb_core_tpu.debruijn.graph import Graph


def test_largeint_hex_format():
    assert largeint_hex(0, 1) == ""
    assert largeint_hex(0xdeadbeef, 1) == "deadbeef"
    # two words, high word non-zero -> '.'-separated high-to-low
    v = (0x1 << 64) | 0x2
    assert largeint_hex(v, 2) == "1.2"
    # wrap-around mod 2^(64*words)
    assert largeint_hex((1 << 64) + 5, 1) == "5"


def test_dbgcheck_stats_consistency(test_db):
    graph = Graph.create(f"{test_db}/reads1.fa", kmer_size=31,
                         abundance_min=3, build_branching=False)
    stats = check_graph(graph)
    assert stats["nbSolids"] == 623
    assert stats["nbBranching"] == 24
    # checksum of branching nodes must equal the Graph's own checksum
    assert stats["checksumBranching"] == graph.checksum_branching()
    # each successor edge adds one node value: count matches out-degrees
    assert stats["nbSuccessors"] == int(graph.out_degree(
        graph.solid_limbs).sum())
    assert stats["abundance"] == int(graph.solid_counts.sum())


def test_bankgen_roundtrip(tmp_path):
    prefix = str(tmp_path / "g")
    bankgen_main(["-out", prefix, "-seq-len", "3000", "-read-len", "80",
                  "-overlap-len", "40", "-coverage", "2"])
    genome = list(BankFasta(prefix + "_sequence.fa"))
    reads = list(BankFasta(prefix + "_reads.fa"))
    assert len(genome) == 1 and len(genome[0]) == 3000
    assert genome[0].comment == "0__len__3000"
    assert all(len(r) <= 80 for r in reads)
    # reads tile the genome with the requested overlap
    assert reads[0].data == genome[0].data[:80]
    assert reads[1].data[:40] == reads[0].data[40:]


def test_kmer_checksum(tmp_path):
    path = str(tmp_path / "kmers.bin")
    vals = [3, 5, 0xFFFFFFFFFFFFFFFF]
    with open(path, "wb") as f:
        for v in vals:
            f.write(struct.pack("<q", v - (1 << 64) if v >= 1 << 63 else v))
    buf = io.StringIO()
    with redirect_stdout(buf):
        checksum_main([path])
    out = buf.getvalue()
    total = sum(vals) % (1 << 64)
    assert f"FOUND 3 WITH CHECKSUM {total:x}" in out


def test_linear_counter_estimates():
    from gatb_core_tpu.kmer.linear_counter import LinearCounter
    from gatb_core_tpu.ops.kmer_ops import py_to_limbs

    rng = np.random.default_rng(0)
    vals = [int(v) for v in rng.choice(2 ** 40, size=2000, replace=False)]
    limbs = np.asarray(py_to_limbs(vals, 31)).astype(np.uint32)
    lc = LinearCounter(20000)
    lc.add(limbs)
    lc.add(limbs)  # duplicate inserts must not inflate the estimate
    assert abs(lc.count() - 2000) / 2000 < 0.1
    assert lc.is_accurate()


def test_estimate_distinct_kmers(test_db):
    from gatb_core_tpu.kmer.linear_counter import estimate_distinct_kmers
    from gatb_core_tpu.kmer.model import count_kmers_py

    n = estimate_distinct_kmers(f"{test_db}/reads1.fa", 31)
    true = len(count_kmers_py(
        [s.data for s in BankFasta(f"{test_db}/reads1.fa")], 31))
    assert 0.5 * true < n < 2.0 * true


def test_new_project_scaffold(tmp_path):
    import subprocess, sys, os
    from gatb_core_tpu.tools.new_project import create_project

    proj = create_project(str(tmp_path), "my-tool", nb_tools=2)
    pkg = os.path.join(proj, "my_tool")
    assert os.path.exists(os.path.join(pkg, "my_tool_1.py"))
    assert os.path.exists(os.path.join(proj, "tests", "test_my_tool_2.py"))
    # generated code parses and its parser exposes reference flag names
    env = dict(os.environ, PYTHONPATH=proj + os.pathsep + os.getcwd(),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         "from my_tool.my_tool_1 import MyTool1; "
         "a = MyTool1.get_options_parser().parse_args(['-in','x.fa']); "
         "print(a.kmer_size)"],
        capture_output=True, text=True, env=env)
    assert out.returncode == 0 and out.stdout.strip() == "31", out.stderr


def test_dbginfo_cli(test_db, tmp_path, capsys):
    """dbginfo dumps kmer_size / state / branching info from a graph .h5
    (reference tools/dbginfo.cpp output fields)."""
    from gatb_core_tpu.tools.dbginfo import main as dbginfo_main

    out_h5 = str(tmp_path / "g.h5")
    Graph.create(f"{test_db}/reads1.fa", kmer_size=31, abundance_min=3,
                 output=out_h5)
    rc = dbginfo_main(["-in", out_h5])
    assert rc == 0
    out = capsys.readouterr().out
    assert "kmer_size    : 31" in out
    assert "nb_solid_kmers : 623" in out
    assert "SORTING_COUNT_DONE" in out and "BRANCHING_DONE" in out
    assert "nb_branching : 24" in out


def test_dbgh5_tool_contract_and_email(tmp_path):
    """Dbgh5Tool on the Tool contract + -email (tools/dbgh5.cpp:98-128:
    piped to the system mail command, non-fatal when absent)."""
    from gatb_core_tpu.tools.dbgh5 import Dbgh5Tool

    tool = Dbgh5Tool()
    rc = tool.main([
        "-in", "/root/reference/gatb-core/test/db/reads1.fa",
        "-kmer-size", "21", "-abundance-min", "1",
        "-out", str(tmp_path / "t.h5"), "-verbose", "0",
        "-email", "nobody@example.invalid", "-email-fmt", "xml",
        "-bloom", "none", "-debloom", "none", "-mphf", "none",
        "-branching-nodes", "none"])
    assert rc == 0
    assert "exec_time" in tool.get_info()


def test_clear_cache_and_bank_download(tmp_path):
    """ClearCache touches the requested bytes; BankDownload fetches a
    file:// URL, gunzips, and annotates stats (BankDownload.cpp /
    ClearCache.cpp equivalents)."""
    import gzip

    from gatb_core_tpu.tools.clear_cache import clear
    from gatb_core_tpu.tools import bank_download

    assert clear(3 << 20, chunk_mb=1, verbose=False) == 3 << 20

    src = tmp_path / "mini.fa.gz"
    with gzip.open(src, "wt") as f:
        f.write(">a\nACGTACGT\n>b\nGGGTTT\n")
    rc = bank_download.main(["-url", src.as_uri(), "-out", str(tmp_path)])
    assert rc == 0
    out = tmp_path / "mini.fa"
    assert out.exists()
    assert "ACGTACGT" in out.read_text()
