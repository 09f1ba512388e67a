"""Bring-up measurements on one NVIDIA GPU.

    python tools_dev/h100_bringup.py

1. environment: h5py, g++/zlib (native parser build), nvcc;
2. what XLA:GPU makes of the counting sorts at the fold's shape (2^25
   rows): the lowering (CUB radix sort custom call or XLA's own sort
   kernel) and the time of each variant;
3. the fold's bitonic merge network, alone and inside
   ``_superbatch_count_fold`` at the dbgh5 superbatch size;
4. k-mer extraction in one batch of B=65536 reads against the numpy
   oracle.

Times are medians of block_until_ready'd calls after a warm-up call.
"""

from __future__ import annotations

import functools
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def sh(cmd):
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        return (r.stdout + r.stderr).strip()
    except OSError as exc:
        return f"unavailable: {exc}"


def timeit(fn, *args, reps=5):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def lowering(compiled) -> str:
    txt = compiled.as_text()
    kinds = []
    if "cub" in txt.lower():
        kinds.append("cub-radix-sort")
    if " sort(" in txt or "sort." in txt:
        kinds.append("xla-sort")
    return "+".join(kinds) or "unknown"


def env_report():
    print("== environment")
    print("nvidia-smi:", sh(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"]))
    try:
        import h5py
        print("h5py:", h5py.__version__)
    except ImportError as exc:
        print("h5py: MISSING", exc)
    print("g++:", sh(["g++", "--version"]).splitlines()[:1])
    print("nvcc:", sh(["/usr/local/cuda/bin/nvcc", "--version"])
          .splitlines()[-1:])
    from gatb_core_tpu import native
    print("native parser:", native.available(), native.build_error())


def sort_report(n=1 << 25):
    import jax
    import jax.numpy as jnp

    print(f"== lax.sort at {n} rows")
    rng = np.random.default_rng(0)
    planes = [jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
              for _ in range(5)]
    cases = [
        ("W=2 keys (raw fold sort, k=31)", 2, 2),
        ("W=2 keys + count key (merge, W+1 planes)", 3, 3),
        ("W=2 keys + count payload", 3, 2),
        ("1 key + W+1 payloads (compaction)", 4, 1),
        ("W=4 keys (raw fold sort, k=63)", 4, 4),
        ("1 uint32 key alone", 1, 1),
    ]
    for name, np_, nk in cases:
        f = jax.jit(functools.partial(jax.lax.sort, num_keys=nk))
        args = (tuple(planes[:np_]),)
        low = lowering(f.lower(*args).compile())
        t = timeit(f, *args)
        print(f"sort {name}: {t * 1e3:.2f} ms, lowering={low}")
    jax.config.update("jax_enable_x64", True)
    k64 = jnp.asarray(rng.integers(0, 2**62, n, dtype=np.uint64))
    pay = planes[0]
    for name, args, nk in [("1 uint64 key (k<=31 packed)", (k64,), 1),
                           ("1 uint64 key + count payload", (k64, pay), 1)]:
        f = jax.jit(functools.partial(jax.lax.sort, num_keys=nk))
        low = lowering(f.lower(args).compile())
        t = timeit(f, args)
        print(f"sort {name}: {t * 1e3:.2f} ms, lowering={low}")
    jax.config.update("jax_enable_x64", False)


def merge_report(run=1 << 25):
    import jax
    import jax.numpy as jnp

    from gatb_core_tpu.ops import sortops

    print(f"== merge network, two runs of {run}, W+1=3 planes")
    rng = np.random.default_rng(1)
    planes = []
    for _ in range(3):
        a = np.sort(rng.integers(0, 2**32, run, dtype=np.uint32))
        b = np.sort(rng.integers(0, 2**32, run, dtype=np.uint32))
        planes.append(jnp.asarray(np.concatenate([a, b])))
    f = jax.jit(functools.partial(sortops._merge_sorted_runs, run=run))
    print(f"merge: {timeit(f, tuple(planes)) * 1e3:.2f} ms")


def fold_report(reads_codes, rows=1 << 25):
    """_superbatch_count_fold at the dbgh5 superbatch shape (G batches of
    1024 reads, L=160, raw mode, cap_acc=2^25)."""
    import jax
    import jax.numpy as jnp

    from gatb_core_tpu.kmer import counting
    from gatb_core_tpu.ops.bitpack import pack_batch_np

    k, L, B = 31, 160, 1024
    G = rows // (B * (L - k + 1))
    n = G * B
    codes = np.zeros((n, L), np.uint8)
    codes[:, :reads_codes.shape[1]] = reads_codes[:n]
    valid = np.zeros((n, L), bool)
    valid[:, :reads_codes.shape[1]] = True
    words, _ = pack_batch_np(codes, valid)
    words = jnp.asarray(words.reshape(G, B, -1))
    lengths = jnp.full((G, B), reads_codes.shape[1], jnp.int32)
    cap = rows
    print(f"== fold: G={G} x {B} reads, L={L}, cap_acc={cap}")
    static = dict(k=k, m=10, nb_passes=1, spare=True, packed=True, L=L,
                  blocked=True, cap_acc=cap, cap_out=None)

    def once():
        acc = jax.block_until_ready(counting._empty_table_jit(w=2, cap=cap))
        t0 = time.perf_counter()
        out = counting._superbatch_count_fold(
            words, None, lengths, jnp.int32(0), acc[0], acc[1], acc[2],
            jnp.bool_(True), **static)
        jax.block_until_ready(out)
        return time.perf_counter() - t0, int(out[2])

    once()
    ts = [once() for _ in range(3)]
    print(f"fold: {min(t for t, _ in ts) * 1e3:.2f} ms, "
          f"distinct={ts[0][1]}")


def extract_report(reads_codes, B=65536):
    import jax.numpy as jnp

    import chip_smoke
    from gatb_core_tpu.ops import kmer_ops
    from gatb_core_tpu.ops.bitpack import pack_batch_np

    L = 160
    print(f"== extraction at B={B}, L={L}")
    codes = np.zeros((B, L), np.uint8)
    codes[:, :reads_codes.shape[1]] = reads_codes[:B]
    valid = np.zeros((B, L), bool)
    valid[:, :reads_codes.shape[1]] = True
    lengths = np.full(B, reads_codes.shape[1], np.int32)
    words, vmask = pack_batch_np(codes, valid)
    for k in (31, 63):
        p = L - k + 1
        exp = chip_smoke.read_kmers(codes, k)
        inside = (np.arange(p)[None, :] + k <= reads_codes.shape[1])
        inside = np.broadcast_to(inside, (B, p)).reshape(-1)
        for name, kb in (
                ("packed", kmer_ops.extract_kmers_packed(
                    jnp.asarray(words), jnp.asarray(vmask),
                    jnp.asarray(lengths), k, L, with_minimizers=False)),
                ("codes", kmer_ops.extract_kmers(
                    jnp.asarray(codes), jnp.asarray(valid),
                    jnp.asarray(lengths), k, with_minimizers=False))):
            got = chip_smoke.limbs_to_words(
                np.asarray(kb.kmers).reshape(-1, kb.kmers.shape[-1]))
            v = np.asarray(kb.valid).reshape(-1)
            ok = np.array_equal(v, inside) and np.array_equal(
                got[inside], exp[inside])
            print(f"extract k={k} {name}: exact={ok} "
                  f"({int(inside.sum())} windows)")


def main():
    import jax

    if jax.devices()[0].platform != "gpu":
        sys.exit("needs a GPU")
    env_report()
    import chip_smoke

    reads = chip_smoke.make_reads(chip_smoke.GENOME_LEN, 1 << 18, 150,
                                  chip_smoke.ERROR_RATE, 1)
    extract_report(reads)
    sort_report()
    merge_report()
    fold_report(reads)


if __name__ == "__main__":
    main()
