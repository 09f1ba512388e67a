"""Host-side k-mer model: slow, obviously-correct Python implementation.

This mirrors gatb-core's ModelCanonical / ModelMinimizer semantics
(src/gatb/kmer/impl/Model.hpp) operating on Python ints of arbitrary width,
for any k. It exists to (a) serve as ground truth in tests for the device ops,
(b) provide string <-> kmer utilities for the public API (Graph.toString,
buildNode, etc. equivalents).
"""

from __future__ import annotations

from dataclasses import dataclass

NUCLEOTIDES = "ACTG"  # index == code (A=0 C=1 T=2 G=3)
_CODE = {"A": 0, "C": 1, "T": 2, "G": 3, "a": 0, "c": 1, "t": 2, "g": 3}


def char_code(ch: str) -> tuple[int, bool]:
    """ASCII char -> (2-bit code, valid). Matches ConvertASCII (Data.hpp:185)."""
    c = _CODE.get(ch)
    if c is None:
        return (ord(ch) >> 1) & 3, False
    return c, True


def revcomp(value: int, k: int) -> int:
    """Reverse complement of a 2-bit packed k-mer value."""
    out = 0
    for _ in range(k):
        out = (out << 2) | ((value & 3) ^ 2)
        value >>= 2
    return out


def kmer_to_string(value: int, k: int) -> str:
    chars = []
    for i in range(k):
        chars.append(NUCLEOTIDES[(value >> (2 * (k - 1 - i))) & 3])
    return "".join(chars)


def string_to_kmer(s: str) -> int:
    v = 0
    for ch in s:
        code, ok = char_code(ch)
        if not ok:
            raise ValueError(f"invalid nucleotide {ch!r}")
        v = (v << 2) | code
    return v


def canonical(value: int, k: int) -> int:
    return min(value, revcomp(value, k))


def mmer_allowed_py(mm: int, m: int) -> bool:
    """is_allowed (Model.hpp:1219-1252): ban 'AA' anywhere except at start."""
    mmask_m1 = (1 << ((m - 2) * 2)) - 1
    mask_ma1 = 0x5555555555555555 & mmask_m1
    a1 = ~(mm | (mm >> 2)) & 0xFFFFFFFFFFFFFFFF
    a1 = ((a1 >> 1) & a1) & mask_ma1
    return a1 == 0


def mmer_lut_value(mm: int, m: int) -> int:
    """The reference _mmer_lut entry (Model.hpp:1040-1065): canonical-or-banned."""
    canon = min(mm, revcomp(mm, m))
    if not mmer_allowed_py(canon, m):
        return (1 << (2 * m)) - 1
    return canon


@dataclass
class ModelCanonical:
    """Iterate canonical k-mers of a sequence with reference validity rules."""

    k: int

    def iter_kmers(self, seq: str):
        """Yield (canonical_value, valid) for every window of ``seq``.

        Validity follows Model.hpp:725-770: a k-mer is valid iff all k of its
        characters are valid nucleotides.
        """
        k = self.k
        if len(seq) < k:
            return
        mask = (1 << (2 * k)) - 1
        fwd = 0
        bad = -1  # countdown like indexBadChar
        for i, ch in enumerate(seq[:k]):
            code, ok = char_code(ch)
            fwd = ((fwd << 2) | code) & mask
            if not ok:
                bad = i
        yield canonical(fwd, k), bad < 0
        for i in range(k, len(seq)):
            code, ok = char_code(seq[i])
            bad = k - 1 if not ok else bad - 1
            fwd = ((fwd << 2) | code) & mask
            yield canonical(fwd, k), bad < 0

    def valid_kmers(self, seq: str):
        return [v for v, ok in self.iter_kmers(seq) if ok]


@dataclass
class ModelMinimizer:
    """Canonical model + minimizers: lexicographic ('banned-AA') by
    default, or frequency-ordered when ``freq_order`` is given
    (ComparatorMinimizerFrequencyOrLex)."""

    k: int
    m: int = 10
    freq_order: object = None  # optional (4^m,) rank array

    def minimizer(self, kmer_fwd: int) -> int:
        """Minimizer value of a kmer given its *forward* value.

        Equals min over all m-mer windows of the forward strand of
        mmer_lut_value (the LUT already folds in revcomp of each m-mer);
        in freq mode the comparator is (rank, value) and nothing is
        banned.
        """
        k, m = self.k, self.m
        mm_mask = (1 << (2 * m)) - 1
        if self.freq_order is None:
            best = mm_mask
            for j in range(k - m + 1):
                mm = (kmer_fwd >> (2 * (k - m - j))) & mm_mask
                best = min(best, mmer_lut_value(mm, m))
            return best
        best = None
        for j in range(k - m + 1):
            mm = (kmer_fwd >> (2 * (k - m - j))) & mm_mask
            canon = min(mm, revcomp(mm, m))
            key = (int(self.freq_order[canon]), canon)
            if best is None or key < best:
                best = key
        return best[1]

    def iter_kmers(self, seq: str):
        """Yield (canonical_value, valid, minimizer_value)."""
        k = self.k
        mask = (1 << (2 * k)) - 1
        if len(seq) < k:
            return
        fwd = 0
        bad = -1
        for i, ch in enumerate(seq[:k]):
            code, ok = char_code(ch)
            fwd = ((fwd << 2) | code) & mask
            if not ok:
                bad = i
        yield canonical(fwd, k), bad < 0, self.minimizer(fwd)
        for i in range(k, len(seq)):
            code, ok = char_code(seq[i])
            bad = k - 1 if not ok else bad - 1
            fwd = ((fwd << 2) | code) & mask
            yield canonical(fwd, k), bad < 0, self.minimizer(fwd)


def count_kmers_py(sequences, k: int, abundance_min: int = 1,
                   abundance_max: int = 2**31 - 1) -> dict[int, int]:
    """Dict-based reference k-mer counter (ground truth for tests)."""
    model = ModelCanonical(k)
    counts: dict[int, int] = {}
    for seq in sequences:
        for v in model.valid_kmers(seq):
            counts[v] = counts.get(v, 0) + 1
    return {v: c for v, c in counts.items()
            if abundance_min <= c <= abundance_max}
