"""Native host runtime (C++): FASTA/FASTQ parsing + 2-bit batch encoding.

The compute path is JAX/XLA on the device; this module is the native
counterpart of the reference's C++ host plumbing (BankFasta parser,
bank/impl/BankFasta.cpp) — it feeds the device pipeline without Python
per-character overhead. Built lazily with g++ from the committed source
into a .so named after the source's hash (so a stale build is never
loaded); callers fall back to the pure-Python implementations when a
toolchain is unavailable, and ``build_error()`` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "fastx.cpp")
_lock = threading.Lock()
_lib = None
_lib_failed = False
_build_error: str | None = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_DIR, f"_fastx-{digest}.so")


def _build(so: str) -> bool:
    global _build_error
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
           "-o", tmp, _SRC, "-lz"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True,
                       timeout=300)
        os.replace(tmp, so)
        return True
    except subprocess.CalledProcessError as exc:
        _build_error = f"{' '.join(cmd)}\n{exc.stderr}"
    except (OSError, subprocess.SubprocessError) as exc:
        _build_error = f"{' '.join(cmd)}\n{exc}"
    return False


def build_error() -> str | None:
    """Why the native library is unavailable (compiler or loader
    message), or None if it loaded or was never requested."""
    return _build_error


def get_lib():
    """Load (building on first use) the native library, or None if
    unavailable."""
    global _lib, _lib_failed, _build_error
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        so = _so_path()
        try:
            if not os.path.exists(so) and not _build(so):
                _lib_failed = True
                return None
            lib = ctypes.CDLL(so)
        except OSError as exc:
            _build_error = f"loading {so}: {exc}"
            _lib_failed = True
            return None

        lib.fastx_open.restype = ctypes.c_void_p
        lib.fastx_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
        lib.fastx_next_batch.restype = ctypes.c_int
        lib.fastx_next_batch.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p] * 3
        lib.fastx_next_batch_packed.restype = ctypes.c_int
        lib.fastx_next_batch_packed.argtypes = [ctypes.c_void_p] + [
            ctypes.c_void_p] * 3
        lib.fastx_stats.restype = None
        lib.fastx_stats.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int64),
                                    ctypes.POINTER(ctypes.c_int64)]
        lib.fastx_stats_full.restype = None
        lib.fastx_stats_full.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_double)]
        lib.fastx_close.restype = None
        lib.fastx_close.argtypes = [ctypes.c_void_p]
        lib.fastx_open_reader.restype = ctypes.c_void_p
        lib.fastx_open_reader.argtypes = [ctypes.c_char_p]
        lib.fastx_next_seq.restype = ctypes.c_int64
        lib.fastx_next_seq.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_char_p)]
        lib.fastx_reader_close.restype = None
        lib.fastx_reader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


class NativeBatcher:
    """Iterator of (codes, valid, lengths, rows) batches over a FASTA/FASTQ
    path, shaped exactly like kmer/counting.py _BatchBuilder output."""

    def __init__(self, path: str, k: int, batch_reads: int, batch_len: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastx library unavailable")
        self._lib = lib
        self.k = k
        self.B = batch_reads
        self.L = max(batch_len, 2 * k)
        self._h = lib.fastx_open(path.encode(), k, self.B, self.L)
        if not self._h:
            raise FileNotFoundError(path)
        self._stats = (0, 0)

    def __iter__(self):
        lib, B, L = self._lib, self.B, self.L
        try:
            while True:
                codes = np.zeros((B, L), np.uint8)
                valid = np.zeros((B, L), np.uint8)
                lengths = np.zeros((B,), np.int32)
                rows = lib.fastx_next_batch(
                    self._h, codes.ctypes.data_as(ctypes.c_void_p),
                    valid.ctypes.data_as(ctypes.c_void_p),
                    lengths.ctypes.data_as(ctypes.c_void_p))
                if rows == 0:
                    break
                yield codes, valid.view(bool), lengths, int(rows)
        finally:
            self.close()

    def iter_packed(self):
        """Packed-transfer batches: (words (B, ceil(L/16)) uint32,
        vmask (B, ceil(L/32)) uint32, lengths, rows) — the 2.25 bits/base
        host->device format (pack_words/pack_valid layout, packed in C++)."""
        lib, B, L = self._lib, self.B, self.L
        nw, nv = (L + 15) // 16, (L + 31) // 32
        try:
            while True:
                words = np.zeros((B, nw), np.uint32)
                vmask = np.zeros((B, nv), np.uint32)
                lengths = np.zeros((B,), np.int32)
                rows = lib.fastx_next_batch_packed(
                    self._h, words.ctypes.data_as(ctypes.c_void_p),
                    vmask.ctypes.data_as(ctypes.c_void_p),
                    lengths.ctypes.data_as(ctypes.c_void_p))
                if rows == 0:
                    break
                yield words, vmask, lengths, int(rows)
        finally:
            self.close()

    def stats(self) -> tuple[int, int]:
        """(nb_sequences, total_size) seen so far (cached after close)."""
        if self._h:
            nb = ctypes.c_int64()
            total = ctypes.c_int64()
            self._lib.fastx_stats(self._h, ctypes.byref(nb),
                                  ctypes.byref(total))
            self._stats = (nb.value, total.value)
        return self._stats

    def stats_full(self) -> tuple[int, int, int, int, float]:
        """(nb, total, min_len, max_len, sumsq) — the BankStats block
        (seq_size_min/max/mean/deviation, SortingCountAlgorithm.cpp:
        735-742)."""
        if self._h:
            nb = ctypes.c_int64()
            total = ctypes.c_int64()
            mn = ctypes.c_int64()
            mx = ctypes.c_int64()
            sq = ctypes.c_double()
            self._lib.fastx_stats_full(
                self._h, ctypes.byref(nb), ctypes.byref(total),
                ctypes.byref(mn), ctypes.byref(mx), ctypes.byref(sq))
            self._stats_full = (nb.value, total.value, mn.value, mx.value,
                                sq.value)
        return getattr(self, "_stats_full", (0, 0, 0, 0, 0.0))

    def close(self):
        if self._h:
            self.stats()
            self.stats_full()    # cache before the handle is freed
            self._lib.fastx_close(self._h)
            self._h = None


class NativeSeqReader:
    """Sequence-payload iterator over a FASTA/FASTQ path (native parse)."""

    def __init__(self, path: str, initial_cap: int = 1 << 16):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native fastx library unavailable")
        self._lib = lib
        self._h = lib.fastx_open_reader(path.encode())
        if not self._h:
            raise FileNotFoundError(path)
        self._cap = initial_cap
        self._buf = ctypes.create_string_buffer(self._cap)

    def __iter__(self):
        lib = self._lib
        big = ctypes.c_char_p()
        try:
            while True:
                n = lib.fastx_next_seq(self._h, self._buf, self._cap,
                                       ctypes.byref(big))
                if n == -1:
                    break
                if n == -2:
                    yield (big.value or b"").decode("ascii")
                    continue
                yield self._buf.raw[:n].decode("ascii")
        finally:
            self.close()

    def close(self):
        if self._h:
            self._lib.fastx_reader_close(self._h)
            self._h = None
