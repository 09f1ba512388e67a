"""Benchmark: k-mer counting throughput (k=31), reads/s on one GPU.

Prints the card (nvidia-smi name and power limit) and the JAX device,
then ONE JSON line:
  {"metric": ..., "value": N, "unit": "reads/s", "vs_baseline": N,
   "device": {...}}

Dataset: synthetic 1 Mbp random genome, 200k x 150 bp reads sampled
uniformly (~30x coverage) — same data the reference baseline (dbgh5,
all CPU cores, see BASELINE.md "Measured") is run on.

The timed unit is one jitted dispatch over the whole staged dataset:
packed extraction (lax.map over 16k-read chunks, minimizers skipped —
the single-pass path never consumes them) -> ONE lax.sort of all ~23.6M
(hi, lo) kmer limb planes -> scan-based distinct reduce + blocked
compaction (ops/sortops.count_planes). Each call ends in
block_until_ready; the best of three warm calls is reported.

Refuses to run when JAX's first device is not a GPU. Set
GATB_BENCH_E2E=1 for the end-to-end SortingCount figure from a FASTA file
on disk.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

# Reference baseline (see BASELINE.md "Measured"): gatb-core dbgh5 v1.4.2
# (Release, -nb-cores 0 on a 2-core x86 host) on the identical synthetic
# FASTA (200k x 150bp reads, 1Mbp genome, k=31, abundance-min=3):
# fill_partitions 0.697s + fill_solid_kmers 0.559s = 1.256s -> 159,236
# reads/s for the counting phase.
REF_READS_PER_S = 159236.0

# Known exact result for this dataset (seed 7): asserted after warmup.
EXPECTED_DISTINCT = 999_959


def make_dataset(n_reads=200_000, read_len=150, genome_len=1_000_000,
                 seed=7):
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    starts = rng.integers(0, genome_len - read_len, size=n_reads)
    idx = starts[:, None] + np.arange(read_len)[None, :]
    reads = genome[idx]  # (n_reads, read_len) 2-bit codes
    return reads


def write_fasta(path, reads):
    nts = np.frombuffer(b"ACTG", dtype=np.uint8)
    with open(path, "wb") as f:
        for i, r in enumerate(reads):
            f.write(b">r%d\n" % i)
            f.write(nts[r].tobytes())
            f.write(b"\n")


def _device_or_exit():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench: no GPU (JAX's first device is {dev.platform}); "
                 "refusing to run")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card}


def main():
    from gatb_core_tpu.system.compile_cache import enable_compile_cache

    enable_compile_cache()
    device = _device_or_exit()

    import jax
    import jax.numpy as jnp

    from gatb_core_tpu.ops.bitpack import pack_batch_np
    from gatb_core_tpu.ops.kmer_ops import extract_kmers_packed, nb_limbs
    from gatb_core_tpu.ops.sortops import count_planes

    K = 31
    B = 16384                   # reads per extraction chunk
    reads = make_dataset()
    n_reads, read_len = reads.shape
    n_batches = n_reads // B
    reads = reads[:n_batches * B]
    total_reads = n_batches * B

    w = nb_limbs(K)
    spare = (2 * K) % 32 != 0
    P = read_len - K + 1
    CAP_OUT = 1 << 20   # > EXPECTED_DISTINCT, bounds the reduce output
    jlengths = jnp.full((B,), read_len, jnp.int32)

    @jax.jit
    def count_once(all_words, all_vmask):
        def ext(args):
            words, vmask = args
            kb = extract_kmers_packed(words, vmask, jlengths, K, read_len,
                                      with_minimizers=False)
            return (tuple(kb.kmers[..., j].reshape(-1) for j in range(w)),
                    kb.valid.reshape(-1))

        planes, val = jax.lax.map(ext, (all_words, all_vmask))
        flat = tuple(p.reshape(-1) for p in planes)
        out_p, counts, n, overflow = count_planes(
            flat, val.reshape(-1), spare_bits=spare, cap_out=CAP_OUT,
            blocked=True)
        return out_p, counts, n, overflow

    words_np, vmask_np = pack_batch_np(
        reads.reshape(-1, read_len),
        np.ones((total_reads, read_len), bool))
    dataset_w = jnp.asarray(words_np.reshape(n_batches, B, -1))
    dataset_v = jnp.asarray(vmask_np.reshape(n_batches, B, -1))
    out = jax.block_until_ready(count_once(dataset_w, dataset_v))
    _, counts, n, overflow = out
    assert not bool(overflow), "CAP_OUT overflow — raise CAP_OUT"
    assert int(jnp.sum(counts)) == total_reads * P, "total kmers mismatch"
    assert int(n) == EXPECTED_DISTINCT, \
        f"distinct {int(n)} != {EXPECTED_DISTINCT}"

    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(count_once(dataset_w, dataset_v))
        elapsed = time.perf_counter() - t0
        best = elapsed if best is None else min(best, elapsed)
    reads_per_s = total_reads / best

    result = {
        "metric": "kmer_count_reads_per_s_chip_k31",
        "value": round(reads_per_s, 1),
        "unit": "reads/s",
        "vs_baseline": round(reads_per_s / REF_READS_PER_S, 3),
        "device": device,
    }
    print(json.dumps(result), flush=True)
    if os.environ.get("GATB_BENCH_E2E", "0") == "1":
        print(json.dumps(run_e2e(reads[:total_reads])), flush=True)


def run_e2e(reads):
    """End-to-end SortingCount.execute on the same reads, from a FASTA
    file on disk: native C++ parse -> packed host->device transfer ->
    superbatch sort/reduce -> solidity -> solid-table fetch. This is the
    path the reference's fill_partitions+fill_solid_kmers numbers measure
    (SortingCountAlgorithm.cpp:636-780)."""
    import tempfile

    from gatb_core_tpu.kmer.counting import SortingCount, CountConfig

    n_reads, read_len = reads.shape
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "reads.fa")
        write_fasta(path, reads)
        cfg = CountConfig(kmer_size=31, abundance_min=3, batch_reads=4096,
                          batch_len=read_len,
                          superbatch_rows=n_reads * (read_len - 30) // 4,
                          # plan-style distinct estimate: 1 Mbp at 30x
                          distinct_ratio_hint=0.06)
        times = []
        res = None
        for _ in range(3):  # the first run compiles
            t0 = time.perf_counter()
            res = SortingCount(cfg).execute(path)
            times.append(time.perf_counter() - t0)
    assert res.info["kmers_nb_valid"] == n_reads * (read_len - 30)
    rps = n_reads / min(times[1:])
    return {
        "e2e_reads_per_s": round(rps, 1),
        "e2e_vs_baseline": round(rps / REF_READS_PER_S, 3),
        "e2e_nb_solid": int(res.nb_solid),
    }


if __name__ == "__main__":
    main()
