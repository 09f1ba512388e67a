"""Round-3 stress-scale conformance: ~35M distinct kmers vs the
reference binary, multi-pass plan forced by a low -max-memory.

Matches VERDICT round-2 item 4: synthetic 30 Mbp genome at 30x
(6M x 150 bp reads), k=31, abundance-min 3, both sides run with
-max-memory 1500 (forces nb_passes > 1 and many superbatches per pass),
then the SOLID COUNT TABLES are compared key-by-key (full arrays, not
samples) along with the histogram and the summary props.

Usage:
  python tools_dev/stress_r3.py [--phase gen|ref|ours|compare|all]
                                [--reads N] [--genome N]
Artifacts under /tmp/gatb_stress_r3/ (30 Mbp FASTA ~ 0.9 GB).
Results are appended to this file's sibling stress_r3_results.json.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DIR = "/tmp/gatb_stress_r3"
FASTA = os.path.join(DIR, "stress.fa")
REF_BIN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".ref_build", "bin", "Release", "dbgh5")
RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "stress_r3_results.json")
K, AMIN, MAXMEM = 31, 3, 1500
# per-k artifact paths (k=31 keeps the historical names so round-3/4
# artifacts stay valid)
REF_H5 = os.path.join(DIR, "ref_stress.h5")
OURS_H5 = os.path.join(DIR, "ours_stress.h5")


def set_k(k):
    global K, REF_H5, OURS_H5
    K = k
    sfx = "" if k == 31 else f"_k{k}"
    REF_H5 = os.path.join(DIR, f"ref_stress{sfx}.h5")
    OURS_H5 = os.path.join(DIR, f"ours_stress{sfx}.h5")
# forces nb_passes=3 on our side: passes = (volume/4)/max_disk + 1
# (ConfigurationAlgorithm.cpp:350 formula; volume ~5.5GB at 720M kmers)
MAXDISK = 600


def log(msg):
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def gen(n_reads, genome_len, read_len=150, seed=11):
    os.makedirs(DIR, exist_ok=True)
    if os.path.exists(FASTA) and os.path.getsize(FASTA) > 0:
        log(f"gen: {FASTA} exists, skipping")
        return
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    nts = np.frombuffer(b"ACTG", dtype=np.uint8)
    chunk = 200_000
    t0 = time.time()
    with open(FASTA + ".tmp", "wb") as f:
        done = 0
        while done < n_reads:
            m = min(chunk, n_reads - done)
            starts = rng.integers(0, genome_len - read_len, size=m)
            idx = starts[:, None] + np.arange(read_len)[None, :]
            block = nts[genome[idx]]
            lines = []
            for i in range(m):
                lines.append(b">r%d\n" % (done + i))
                lines.append(block[i].tobytes())
                lines.append(b"\n")
            f.write(b"".join(lines))
            done += m
            log(f"gen: {done}/{n_reads} reads")
    os.replace(FASTA + ".tmp", FASTA)
    log(f"gen: wrote {FASTA} ({os.path.getsize(FASTA) >> 20} MB, "
        f"{time.time() - t0:.0f}s)")


def run_ref():
    t0 = time.time()
    cmd = [REF_BIN, "-in", FASTA, "-kmer-size", str(K),
           "-abundance-min", str(AMIN), "-max-memory", str(MAXMEM),
           "-nb-cores", "2", "-out", REF_H5,
           "-bloom", "none", "-debloom", "none",
           "-branching-nodes", "none", "-verbose", "1"]
    log("ref: " + " ".join(cmd))
    out = subprocess.run(cmd, capture_output=True, text=True)
    el = time.time() - t0
    log(f"ref: rc={out.returncode} in {el:.0f}s")
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-3000:])
        sys.exit(1)
    with open(os.path.join(DIR, "ref_stdout.txt"), "w") as f:
        f.write(out.stdout)
    return el


def run_ours():
    t0 = time.time()
    cmd = [sys.executable, "-m", "gatb_core_tpu.tools.dbgh5",
           "-in", FASTA, "-kmer-size", str(K),
           "-abundance-min", str(AMIN), "-max-memory", str(MAXMEM),
           "-max-disk", str(MAXDISK),
           "-out", OURS_H5, "-bloom", "none", "-debloom", "none",
           "-branching-nodes", "none", "-mphf", "none", "-verbose", "1"]
    log("ours: " + " ".join(cmd))
    out = subprocess.run(cmd, capture_output=True, text=True)
    el = time.time() - t0
    log(f"ours: rc={out.returncode} in {el:.0f}s")
    if out.returncode != 0:
        print(out.stdout[-3000:], out.stderr[-3000:])
        sys.exit(1)
    with open(os.path.join(DIR, "ours_stdout.txt"), "w") as f:
        f.write(out.stdout)
    return el


def run_ours_warm():
    """Cold + warm wall-clock in ONE process: 'warm' means the
    in-process jit cache, so the second run is pure steady-state
    parse/transfer/compute. Records both, plus the distinct-program
    count of each run (nb_device_programs)."""
    from gatb_core_tpu.tools import dbgh5 as dbgh5_tool

    times = {}
    for label in ("cold", "warm"):
        out = OURS_H5.replace(".h5", f"_{label}.h5")
        t0 = time.time()
        rc = dbgh5_tool.main([
            "-in", FASTA, "-kmer-size", str(K),
            "-abundance-min", str(AMIN), "-max-memory", str(MAXMEM),
            "-max-disk", str(MAXDISK), "-out", out, "-bloom", "none",
            "-debloom", "none", "-branching-nodes", "none",
            "-mphf", "none", "-verbose", "1"])
        el = time.time() - t0
        assert rc == 0, rc
        log(f"ours[{label}]: {el:.0f}s")
        times[f"ours_seconds_{label}"] = round(el, 1)
    return times


def compare(ours_h5=None):
    import h5py

    from gatb_core_tpu.debruijn.graph import Graph

    log("compare: loading both graphs")
    ref = Graph.load(REF_H5)
    ours = Graph.load(ours_h5 or OURS_H5)
    res = {"n_ref": len(ref.solid_limbs), "n_ours": len(ours.solid_limbs)}
    assert res["n_ref"] == res["n_ours"], res
    # full key-by-key table equality (loader returns value-sorted tables)
    assert np.array_equal(ref.solid_limbs, ours.solid_limbs), \
        "solid kmer sets differ"
    assert np.array_equal(ref.solid_counts, ours.solid_counts), \
        "solid counts differ"
    with h5py.File(REF_H5, "r") as fr, \
            h5py.File(ours_h5 or OURS_H5, "r") as fo:
        hr = fr["histogram/histogram"][:]
        ho = fo["histogram/histogram"][:]
        assert np.array_equal(hr, ho), "histograms differ"
        res["histogram_rows"] = int(len(hr))
    res["solid_equal"] = True
    log(f"compare: OK — {res}")
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", default="all")
    ap.add_argument("--reads", type=int, default=6_000_000)
    ap.add_argument("--genome", type=int, default=30_000_000)
    ap.add_argument("--k", type=int, default=31)
    ap.add_argument("--json-out", default=None,
                    help="also write the result row to this path "
                         "(driver-rerunnable artifact)")
    args = ap.parse_args()
    set_k(args.k)
    results = {"reads": args.reads, "genome": args.genome, "k": K,
               "abundance_min": AMIN, "max_memory": MAXMEM}
    if args.phase in ("gen", "all"):
        gen(args.reads, args.genome)
    if args.phase in ("ref", "all"):
        results["ref_seconds"] = run_ref()
    if args.phase in ("ours", "all"):
        results["ours_seconds"] = run_ours()
    if args.phase == "warm":
        results.update(run_ours_warm())
    if args.phase in ("compare", "all"):
        results.update(compare())
    if args.phase == "warmcompare":
        # key-by-key equality of the WARM run's table (bank-cache path)
        results.update(compare(OURS_H5.replace(".h5", "_warm.h5")))
    with open(RESULTS, "a") as f:
        f.write(json.dumps(results) + "\n")
    if args.json_out:
        with open(args.json_out, "w") as f:
            f.write(json.dumps(results) + "\n")
    log("done: " + json.dumps(results))


if __name__ == "__main__":
    main()
