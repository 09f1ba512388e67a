"""Reference `.leon` container decompression (byte-exact).

Port of the reference Leon decompressor (tools/compression/Leon.cpp:
executeDecompression/startDecompressionAllStreams, HeaderCoder.cpp
HeaderDecoder, DnaCoder.cpp DnaDecoder/QualDecoder): a Leon file is an
HDF5 container —

  /metadata            infobyte, kmerSize (+ 'type'/'header'/'version'
                       properties stored as HDF5 attrs on infobyte)
  /leon/bloom          neighbor-coherent Bloom over solid kmers
                       (attrs: size, nb_hash, kmer_size, type)
  /leon/anchors        anchorsDict (range-coded 2-bit anchor kmers),
                       size, anchorAdress (= anchor count)
  /leon/header         firstheader, blocksizes, header_<i> range-coded
                       header diff streams
  /leon/dna            blocksizes, dna_<i> range-coded read streams
                       (anchor address + pos + error positions + Bloom-
                       guided extension bifurcations)
  /leon/qual           qual_<i> zlib streams (FASTQ only)

The decoder is host-side scalar Python (u64 int arithmetic): Leon decode
is a sequential adaptive-model process with data-dependent branching —
a poor fit for a data-parallel device — and runs once per file at
I/O speed; the device path consumes the decoded reads downstream.
"""

from __future__ import annotations

import zlib

from .range_coder import Order0Model, RangeDecoder
from ..collections.bloom_data import RANDOM_VALUES
from ..collections.bloom import bloom_seeds, CANO2

M64 = (1 << 64) - 1
NB_MODELS_PER_NUMERIC = 20

# Leon nucleotide order (Leon.cpp:56): A C T G N — the GATB 2-bit codes
BIN2NT = "ACTGN"
NT2BIN = {c: i for i, c in enumerate(BIN2NT)}

# header field types (HeaderCoder.hpp:52)
HEADER_END = 1
HEADER_END_MATCH = 2
FIELD_ASCII = 3
FIELD_NUMERIC = 4
FIELD_DELTA = 5
FIELD_DELTA_2 = 6
FIELD_ZERO_ONLY = 7
FIELD_ZERO_AND_NUMERIC = 8
HEADER_TYPE_COUNT = 9


def _hash64(key: int, seed: int) -> int:
    """NativeInt64::hash64 (NativeInt64.hpp:175-188), python ints."""
    h = seed
    h ^= (h << 7) ^ (key * (h >> 3)) ^ (~((h << 11) + (key ^ (h >> 5))) & M64)
    h &= M64
    h = ((~h & M64) + (h << 21)) & M64
    h ^= h >> 24
    h = (h + (h << 3) + (h << 8)) & M64
    h ^= h >> 14
    h = (h + (h << 2) + (h << 4)) & M64
    h ^= h >> 28
    return (h + (h << 31)) & M64


def _simplehash16(key: int, shift: int) -> int:
    """LargeInt<1>::simplehash16_64 (LargeInt1.pri:190-201): the 3-byte
    variant (Leon kmers are span-32 LargeInt<1>)."""
    inp = key >> shift
    res = RANDOM_VALUES[inp & 255]
    inp >>= 8
    res ^= RANDOM_VALUES[inp & 255]
    res ^= RANDOM_VALUES[key & 255]
    return res


def _revcomp(x: int, k: int) -> int:
    """revcomp of a direct 2k-bit kmer (complement = code ^ 2)."""
    out = 0
    for _ in range(k):
        out = (out << 2) | ((x & 3) ^ 2)
        x >>= 2
    return out


class NeighborBloom:
    """BloomNeighborCoherent probe logic over a loaded byte array
    (Bloom.hpp:514-685), only what the Leon decoder needs: contains4."""

    def __init__(self, data: bytes, size_bits: int, nb_hash: int, k: int):
        self.data = data
        self.reduced = size_bits
        self.nb_hash = nb_hash
        self.k = k
        self.seeds = bloom_seeds(0)
        self.mask_block = (1 << 12) - 1
        self.kmer_mask = (1 << (2 * k)) - 1
        self.maskkm2 = (1 << (2 * (k - 2))) - 1

    def _bit(self, pos: int) -> int:
        return (self.data[pos >> 3] >> (pos & 7)) & 1

    def contains4(self, item: int, right: bool) -> list[bool]:
        k = self.k
        shifts = 2 * (k - 1)
        if right:
            elem = (item << 2) & self.kmer_mask
        else:
            elem = item >> 2
        hashpart = (elem >> 2) & self.maskkm2
        rev = _revcomp(hashpart, k - 2)
        if rev < hashpart:
            hashpart = rev
        racine = _hash64(hashpart, self.seeds[0]) % self.reduced

        def h_of(tmp):
            suffix = tmp & 3
            prefix = ((tmp & (3 << shifts)) >> (2 * (k - 2))) + suffix
            return racine + (CANO2[prefix & 15] & self.mask_block)

        bases = [h_of(elem + (nt if right else nt << shifts))
                 for nt in range(4)]
        tab = [_simplehash16(hashpart, i) & self.mask_block
               for i in range(1, self.nb_hash)]
        out = []
        for b in bases:
            ok = self._bit(b) != 0
            if ok:
                for t in tab:
                    if self._bit(b + t) == 0:
                        ok = False
                        break
            out.append(ok)
        return out

    def contains(self, item: int) -> bool:
        """BloomNeighborCoherent::contains (Bloom.hpp:597-645) — single
        kmer membership probe, used by the lossy qual smoother's solid-
        coverage pass (DnaCoder.cpp:489 storeSolidCoverageInfo)."""
        k = self.k
        hashpart = (item >> 2) & self.maskkm2
        rev = _revcomp(hashpart, k - 2)
        if rev < hashpart:
            hashpart = rev
        racine = _hash64(hashpart, self.seeds[0]) % self.reduced
        suffix = item & 3
        prefix = (((item >> (2 * (k - 2))) & 12) + suffix) & 15
        h0 = racine + CANO2[prefix]
        if not self._bit(h0):
            return False
        for i in range(1, self.nb_hash):
            if not self._bit(
                    h0 + (_simplehash16(hashpart, i) & self.mask_block)):
                return False
        return True


def _decode_numeric(dec: RangeDecoder, models: list[Order0Model]) -> int:
    """CompressionUtils::decodeNumeric (VBE, CompressionUtils.hpp:114)."""
    i = 0
    value = 0
    shift = 0
    while True:
        byte = dec.next_byte(models[i])
        value += (byte & 127) << shift
        shift += 7
        i += 1
        if byte <= 127:
            return value


def _numeric_models() -> list[Order0Model]:
    return [Order0Model(256) for _ in range(NB_MODELS_PER_NUMERIC)]


# ---------------------------------------------------------------------------
# Header decoding (HeaderCoder.cpp HeaderDecoder + AbstractHeaderCoder)
# ---------------------------------------------------------------------------


def _type_of_char(c: str):
    if c.isdigit():
        return 1, True
    if c.isalpha():
        return 1, False
    return 2, False


class _HeaderDecoder:
    def __init__(self, first_header: str):
        self.first_header = first_header
        self.header_size_model = Order0Model(256)
        self.type_model: list[Order0Model] = []
        self.field_index_model: list[Order0Model] = []
        self.field_column_model: list[Order0Model] = []
        self.mis_size_model: list[Order0Model] = []
        self.ascii_model: list[Order0Model] = []
        self.zero_model: list[Order0Model] = []
        self.numeric_models: list[list[Order0Model]] = []
        self.prev_field_pos: list[int] = [0]
        self.cur_field_pos: list[int] = [0]
        self.prev_field_values: list[int] = [0]
        self.cur_field_values: list[int] = [0]
        self.prev_field_count = 0

    def _ensure(self, idx: int):
        while len(self.type_model) <= idx:
            self.type_model.append(Order0Model(HEADER_TYPE_COUNT + 1))
            self.field_index_model.append(Order0Model(256))
            self.field_column_model.append(Order0Model(256))
            self.mis_size_model.append(Order0Model(256))
            self.ascii_model.append(Order0Model(128))
            self.zero_model.append(Order0Model(256))
            self.numeric_models.append(_numeric_models())
            self.prev_field_pos.append(0)
            self.cur_field_pos.append(0)
            self.prev_field_values.append(0)
            self.cur_field_values.append(0)

    # -- splitHeader/makeField (HeaderCoder.cpp:80-165) -----------------
    def _split(self, header: str):
        field_index = 0
        start = 0
        numeric = True
        if not header:
            self.cur_field_count = 0
            return
        last_type, _ = _type_of_char(header[0])
        pos = 0
        for pos in range(len(header)):
            ctype, digit = _type_of_char(header[pos])
            if ctype != last_type:
                last_type = ctype
                field_index, start, numeric = self._make_field(
                    header, field_index, start, pos, numeric)
            if numeric:
                numeric = digit
        field_index, start, numeric = self._make_field(
            header, field_index, start, len(header), numeric)
        self.cur_field_count = field_index

    def _make_field(self, header, field_index, start, pos, numeric):
        if start == pos:
            return field_index, start, True
        self._ensure(field_index + 1)
        self.cur_field_pos[field_index] = start
        self.cur_field_pos[field_index + 1] = pos
        if numeric:
            field = header[start:pos].lstrip("0")
            self.cur_field_values[field_index] = int(field) if field else 0
        return field_index + 1, pos, True

    def _end_header(self, header: str):
        self._split(header)
        self.prev_field_count = self.cur_field_count
        for i in range(self.prev_field_count + 1):
            self.prev_field_pos[i] = self.cur_field_pos[i]
            self.prev_field_values[i] = self.cur_field_values[i]
        self.prev_header = header

    def start_block(self):
        for i in range(len(self.type_model)):
            self.type_model[i].clear()
            self.field_index_model[i].clear()
            self.field_column_model[i].clear()
            self.mis_size_model[i].clear()
            self.ascii_model[i].clear()
            self.zero_model[i].clear()
            for m in self.numeric_models[i]:
                m.clear()
        self.header_size_model.clear()
        self._end_header(self.first_header)

    def decode_block(self, data: bytes, sequence_count: int) -> list[str]:
        self.start_block()
        dec = RangeDecoder(data)
        headers = []
        cur = ""
        field_index = 0
        mis_index = 0
        done = 0
        while done < sequence_count:
            self._ensure(mis_index)
            t = dec.next_byte(self.type_model[mis_index])
            if t == HEADER_END:
                headers.append(cur)
                self._end_header(cur)
                cur = ""
                field_index = 0
                mis_index = 0
                done += 1
            elif t == HEADER_END_MATCH:
                hsize = dec.next_byte(self.header_size_model)
                while field_index < self.prev_field_count:
                    cur += self.prev_header[
                        self.prev_field_pos[field_index]:
                        self.prev_field_pos[field_index + 1]]
                    field_index += 1
                    if len(cur) >= hsize:
                        break
                headers.append(cur)
                self._end_header(cur)
                cur = ""
                field_index = 0
                mis_index = 0
                done += 1
            else:
                # decodeMatch (HeaderCoder.cpp:660)
                mis_field = dec.next_byte(self.field_index_model[mis_index])
                while field_index < mis_field:
                    cur += self.prev_header[
                        self.prev_field_pos[field_index]:
                        self.prev_field_pos[field_index + 1]]
                    field_index += 1
                if t == FIELD_ASCII:
                    mis_col = dec.next_byte(
                        self.field_column_model[mis_index])
                    mis_size = dec.next_byte(self.mis_size_model[mis_index])
                    if field_index < self.prev_field_count:
                        base = self.prev_field_pos[field_index]
                        cur += self.prev_header[base:base + mis_col]
                    for _ in range(mis_size):
                        cur += chr(dec.next_byte(self.ascii_model[mis_index]))
                    field_index += 1
                    mis_index += 1
                elif t == FIELD_NUMERIC:
                    v = _decode_numeric(dec, self.numeric_models[mis_index])
                    cur += str(v)
                    field_index += 1
                    mis_index += 1
                elif t == FIELD_DELTA:
                    v = _decode_numeric(dec, self.numeric_models[mis_index])
                    cur += str((self.prev_field_values[field_index] + v)
                               & M64)
                    field_index += 1
                    mis_index += 1
                elif t == FIELD_DELTA_2:
                    v = _decode_numeric(dec, self.numeric_models[mis_index])
                    cur += str((self.prev_field_values[field_index] - v)
                               & M64)
                    field_index += 1
                    mis_index += 1
                elif t == FIELD_ZERO_ONLY:
                    zc = dec.next_byte(self.zero_model[mis_index])
                    cur += "0" * zc
                    field_index += 1
                    mis_index += 1
                elif t == FIELD_ZERO_AND_NUMERIC:
                    zc = dec.next_byte(self.zero_model[mis_index])
                    cur += "0" * zc
                    mis_index += 1
                else:
                    raise ValueError(f"bad header type {t}")
        return headers


# ---------------------------------------------------------------------------
# DNA decoding (DnaCoder.cpp DnaDecoder)
# ---------------------------------------------------------------------------


class _DnaDecoder:
    def __init__(self, k: int, bloom: NeighborBloom, anchors: list[int]):
        self.k = k
        self.bloom = bloom
        self.anchors = anchors
        self.kmer_mask = (1 << (2 * k)) - 1

    def _new_models(self):
        self.read_type = Order0Model(2)
        self.no_anchor_read = Order0Model(5)
        self.bifurcation = Order0Model(5)
        self.bifurcation_binary = Order0Model(2)
        self.revcomp_model = Order0Model(2)
        self.read_size = _numeric_models()
        self.anchor_pos = _numeric_models()
        self.anchor_address = _numeric_models()
        self.numeric = _numeric_models()
        self.npos = _numeric_models()
        self.left_error = _numeric_models()
        self.left_error_pos = _numeric_models()
        self.no_anchor_read_size = _numeric_models()

    def _seed_right(self, kmer: int, nt: int) -> int:
        return ((kmer << 2) | nt) & self.kmer_mask

    def _seed_left(self, kmer: int, nt: int) -> int:
        return (kmer >> 2) | (nt << (2 * (self.k - 1)))

    def _code_seed(self, kmer: int, nt: int, right: bool) -> int:
        return self._seed_right(kmer, nt) if right \
            else self._seed_left(kmer, nt)

    def decode_block(self, data: bytes, sequence_count: int) -> list[str]:
        self._new_models()
        dec = RangeDecoder(data)
        reads = []
        for _ in range(sequence_count):
            rt = dec.next_byte(self.read_type)
            if rt == 0:
                reads.append(self._decode_anchor_read(dec))
            else:
                size = _decode_numeric(dec, self.no_anchor_read_size)
                reads.append("".join(
                    BIN2NT[dec.next_byte(self.no_anchor_read)]
                    for _ in range(size)))
        return reads

    def _decode_anchor_read(self, dec: RangeDecoder) -> str:
        k = self.k
        read_size = _decode_numeric(dec, self.read_size)
        anchor_pos = _decode_numeric(dec, self.anchor_pos)
        anchor_address = _decode_numeric(dec, self.anchor_address)
        anchor = self.anchors[anchor_address]
        if dec.next_byte(self.revcomp_model) == 1:
            anchor = _revcomp(anchor, k)
        seq = [BIN2NT[(anchor >> (2 * (k - 1 - i))) & 3] for i in range(k)]
        npos = set()
        prev = 0
        for _ in range(_decode_numeric(dec, self.numeric)):
            p = _decode_numeric(dec, self.npos) + prev
            npos.add(p)
            prev = p
        err = set()
        prev = 0
        for _ in range(_decode_numeric(dec, self.left_error)):
            p = _decode_numeric(dec, self.left_error_pos) + prev
            err.add(p)
            prev = p

        left: list[str] = []
        right: list[str] = []

        def extend(kmer, pos, is_right, out):
            # DnaDecoder::extendAnchor (DnaCoder.cpp:1586-1758)
            if pos in npos:
                out.append("A")
                return self._code_seed(kmer, 0, is_right)
            if pos in err:
                nt = dec.next_byte(self.bifurcation)
                out.append(BIN2NT[nt])
                res4 = self.bloom.contains4(kmer, is_right)
                for b in range(4):
                    if res4[b]:
                        return self._code_seed(kmer, b, is_right)
                # no solid continuation: fall through like the reference
                # (the C code continues into the generic path and appends
                # a second nucleotide)
            res4 = self.bloom.contains4(kmer, is_right)
            hits = [b for b in range(4) if res4[b]]
            if len(hits) == 1:
                nt = hits[0]
                kmer = self._code_seed(kmer, nt, is_right)
            elif len(hits) == 2:
                which = dec.next_byte(self.bifurcation_binary)
                nt = hits[0] if which == 0 else hits[1]
                kmer = self._code_seed(kmer, nt, is_right)
            else:
                nt = dec.next_byte(self.bifurcation)
                kmer = self._code_seed(kmer, nt, is_right)
            out.append(BIN2NT[nt])
            return kmer

        kmer = anchor
        for i in range(anchor_pos - 1, -1, -1):
            kmer = extend(kmer, i, False, left)
        kmer = anchor
        for i in range(anchor_pos + k, read_size):
            kmer = extend(kmer, i, True, right)

        chars = list("".join(reversed(left)) + "".join(seq)
                     + "".join(right))
        for p in npos:
            if p < len(chars):
                chars[p] = "N"
        return "".join(chars)


# ---------------------------------------------------------------------------
# Container driver (Leon::executeDecompression)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Reference-container COMPRESSION (decoder-in-the-loop)
#
# The encoder simulates the reference decoder's extension automaton exactly
# (same contains4 probes on the same byte-identical neighbor Bloom), so a
# stream it emits decodes to the original reads on the reference leon
# binary — interoperability by construction rather than by mirroring the
# reference encoder's quirks.
# ---------------------------------------------------------------------------


from .range_coder import RangeEncoder

READ_PER_BLOCK = 50000


class _DnaEncoder:
    def __init__(self, k: int, bloom: NeighborBloom):
        self.k = k
        self.bloom = bloom
        self.kmer_mask = (1 << (2 * k)) - 1
        self.anchor_index: dict[int, int] = {}
        self.anchor_list: list[int] = []

    def _seed(self, kmer: int, nt: int, right: bool) -> int:
        if right:
            return ((kmer << 2) | nt) & self.kmer_mask
        return (kmer >> 2) | (nt << (2 * (self.k - 1)))

    def _find_anchor(self, read: str):
        """Reference anchor policy (r5, closes the size gap vs the
        reference binary): first any EXISTING anchor across all windows
        (DnaEncoder::findExistingAnchor, DnaCoder.cpp:563-577); else
        insert a SOLID (bloom-contained) kmer, preferring the mid-read
        window [n/2, n/2+10) then [0, n/2) then [n/2+10, end)
        (Leon::findAndInsertAnchor, Leon.cpp:1105-1190 — mid anchors
        predict both directions); else None -> no-anchor read. The r4
        encoder inserted the first N-free window even when non-solid,
        growing the anchor dict with unpredictable kmers (~+10% size)."""
        k = self.k
        n = len(read)
        nk = n - k + 1
        wins: list = [None] * nk
        for i in range(nk):
            w = read[i:i + k]
            if "N" in w:
                continue
            fwd = 0
            for c in w:
                fwd = (fwd << 2) | NT2BIN[c]
            wins[i] = (i, fwd, min(fwd, _revcomp(fwd, k)))
        for win in wins:
            if win is not None and win[2] in self.anchor_index:
                return win
        i_min = max(nk // 2, 0)
        i_max = min(i_min + 10, nk)
        order = list(range(i_min, i_max)) + list(range(0, i_min)) \
            + list(range(i_max, nk))
        for i in order:
            win = wins[i]
            if win is not None and self.bloom.contains(win[2]):
                return win
        return None

    def _anchor_address(self, canon: int) -> int:
        if canon not in self.anchor_index:
            self.anchor_index[canon] = len(self.anchor_list)
            self.anchor_list.append(canon)
        return self.anchor_index[canon]

    def encode_block(self, reads: list[str]):
        """Range-encode one block; returns bytes."""
        k = self.k
        enc = RangeEncoder()
        read_type = Order0Model(2)
        no_anchor_read = Order0Model(5)
        bifurcation = Order0Model(5)
        bifurcation_binary = Order0Model(2)
        revcomp_model = Order0Model(2)
        read_size = _numeric_models()
        anchor_pos_m = _numeric_models()
        anchor_address_m = _numeric_models()
        numeric = _numeric_models()
        npos_m = _numeric_models()
        left_error = _numeric_models()
        left_error_pos = _numeric_models()
        no_anchor_read_size = _numeric_models()

        def enc_numeric(models, value):
            i = 0
            while True:
                byte = value & 127
                value >>= 7
                if value:
                    enc.encode(models[i], byte | 128)
                else:
                    enc.encode(models[i], byte)
                    return
                i += 1

        for read in reads:
            found = self._find_anchor(read) if len(read) >= k else None
            if found is None:
                enc.encode(read_type, 1)
                enc_numeric(no_anchor_read_size, len(read))
                for c in read:
                    enc.encode(no_anchor_read, NT2BIN.get(c, 4))
                continue
            anchor_pos, fwd, canon = found
            address = self._anchor_address(canon)
            npos = [i for i, c in enumerate(read) if c == "N"]
            npos_set = set(npos)

            # simulate the decoder's extension to pick error positions and
            # the bifurcation byte stream (mirror of _DnaDecoder.extend)
            errors: list[int] = []
            bif_stream: list[tuple] = []  # ('bif', nt) | ('bin', b)

            def simulate(kmer, positions, right):
                for pos in positions:
                    if pos in npos_set:
                        kmer = self._seed(kmer, 0, right)
                        continue
                    true_bin = NT2BIN[read[pos]]
                    res4 = self.bloom.contains4(kmer, right)
                    hits = [b for b in range(4) if res4[b]]
                    if len(hits) == 1:
                        if hits[0] == true_bin:
                            kmer = self._seed(kmer, true_bin, right)
                        else:
                            # decoder error path: emits the true char,
                            # kmer follows the first Bloom hit
                            errors.append(pos)
                            bif_stream.append(("bif", true_bin))
                            kmer = self._seed(kmer, hits[0], right)
                    elif len(hits) == 2:
                        if true_bin in hits:
                            bif_stream.append(
                                ("bin", 0 if hits[0] == true_bin else 1))
                            kmer = self._seed(kmer, true_bin, right)
                        else:
                            errors.append(pos)
                            bif_stream.append(("bif", true_bin))
                            kmer = self._seed(kmer, hits[0], right)
                    else:
                        # 0 or >= 3 hits: decoder reads a bifurcation byte
                        # and follows it
                        bif_stream.append(("bif", true_bin))
                        kmer = self._seed(kmer, true_bin, right)
                return kmer

            simulate(fwd, range(anchor_pos - 1, -1, -1), False)
            simulate(fwd, range(anchor_pos + k, len(read)), True)

            enc.encode(read_type, 0)
            enc_numeric(read_size, len(read))
            enc_numeric(anchor_pos_m, anchor_pos)
            enc_numeric(anchor_address_m, address)
            enc.encode(revcomp_model, 0 if fwd == canon else 1)
            enc_numeric(numeric, len(npos))
            prev = 0
            for p in npos:
                enc_numeric(npos_m, p - prev)
                prev = p
            errors.sort()
            enc_numeric(left_error, len(errors))
            prev = 0
            for p in errors:
                enc_numeric(left_error_pos, p - prev)
                prev = p
            for kind, v in bif_stream:
                if kind == "bif":
                    enc.encode(bifurcation, v)
                else:
                    enc.encode(bifurcation_binary, v)
        enc.flush()
        return enc.get_buffer()

    def encode_anchor_dict(self) -> bytes:
        enc = RangeEncoder()
        model = Order0Model(5)
        k = self.k
        for canon in self.anchor_list:
            for i in range(k):
                enc.encode(model, (canon >> (2 * (k - 1 - i))) & 3)
        enc.flush()
        return enc.get_buffer()


class _HeaderEncoder:
    """Emits the simple universal op sequence per header: FIELD_ASCII
    chunks (misField=0, misColumn=0) + HEADER_END — decodes on the
    reference state machine to exactly the original header."""

    def __init__(self, first_header: str):
        self.first_header = first_header

    def encode_block(self, headers: list[str]) -> bytes:
        enc = RangeEncoder()
        header_size_model = Order0Model(256)
        type_models: list[Order0Model] = []
        field_index_models: list[Order0Model] = []
        field_column_models: list[Order0Model] = []
        mis_size_models: list[Order0Model] = []
        ascii_models: list[Order0Model] = []

        def ensure(idx):
            while len(type_models) <= idx:
                type_models.append(Order0Model(HEADER_TYPE_COUNT + 1))
                field_index_models.append(Order0Model(256))
                field_column_models.append(Order0Model(256))
                mis_size_models.append(Order0Model(256))
                ascii_models.append(Order0Model(128))

        for h in headers:
            mis = 0
            pos = 0
            while pos < len(h):
                chunk = h[pos:pos + 255]
                ensure(mis)
                enc.encode(type_models[mis], FIELD_ASCII)
                enc.encode(field_index_models[mis], 0)
                enc.encode(field_column_models[mis], 0)
                enc.encode(mis_size_models[mis], len(chunk))
                for c in chunk:
                    enc.encode(ascii_models[mis], ord(c) & 127)
                mis += 1
                pos += 255
            ensure(mis)
            enc.encode(type_models[mis], HEADER_END)
        enc.flush()
        return enc.get_buffer()


def _smooth_quals(read: str, qual: str, bloom: NeighborBloom,
                  k: int) -> str:
    """Lossy quality smoothing — the reference's default FASTQ mode
    (DnaCoder.cpp:428-486 smoothQuals/apply_smoothing_at_pos plus
    storeSolidCoverageInfo:489-517): a position covered by >= 2 solid
    kmers, or any qual above '@' (truncation mode), is flattened to '@';
    phred 0 and phred 2 are preserved verbatim, and a qual more than 10
    below '@' is smoothed only when its solid coverage exceeds
    (gap - 5). Reads shorter than k are untouched (smoothQuals guard)."""
    L = len(read)
    if L < k or not qual:
        return qual
    # N -> A substitution before the kmer sweep (DnaCoder.cpp:523-528)
    codes = [NT2BIN.get(c, 0) if c != "N" else 0 for c in read]
    nb_solids = [0] * L
    mask = (1 << (2 * k)) - 1
    kmer = 0
    for i, c in enumerate(codes):
        kmer = ((kmer << 2) | c) & mask
        if i >= k - 1:
            canon = min(kmer, _revcomp(kmer, k))
            if bloom.contains(canon):
                for j in range(i - k + 1, i + 1):
                    nb_solids[j] += 1
    out = list(qual)
    at = ord("@")
    for i in range(L):
        ci = ord(out[i])
        if nb_solids[i] >= 2 or ci > at:
            phred = ci - 33
            if phred == 0 or phred == 2:
                continue
            diff = at - ci
            if diff > 10 and not nb_solids[i] > diff - 5:
                continue
            out[i] = "@"
    return "".join(out)


def leon_ref_compress(path_in: str, path_out: str, kmer_size: int = 31,
                      abundance_min=2,
                      reads_per_block: int = READ_PER_BLOCK,
                      lossless: bool = False) -> dict:
    """Compress a FASTA/FASTQ file into the reference .leon HDF5 container
    (decodable by the reference leon binary). FASTQ qualities default to
    the reference's lossy smoothing mode (Leon.cpp:409-412 — '-lossless'
    opts out there and `lossless=True` does here)."""
    import h5py
    import numpy as np

    from ..bank.fasta import open_bank
    from ..kmer.counting import count_kmers
    from ..collections.bloom import _bloom_build, optimal_params
    import jax.numpy as jnp

    k = kmer_size
    bank = open_bank(path_in)
    seqs = list(bank)
    is_fastq = seqs[0].quality is not None if seqs else False

    # solid kmers -> byte-exact neighbor-coherent Bloom (prediction oracle)
    res = count_kmers(path_in, kmer_size=k, abundance_min=abundance_min)
    size_bits, n_hash = optimal_params(max(len(res.solid_kmers), 1), 10.0)
    words = _bloom_build(jnp.asarray(res.solid_kmers) if
                         len(res.solid_kmers) else
                         jnp.zeros((1, (2 * k + 31) // 32), jnp.uint32),
                         jnp.asarray(np.ones(max(len(res.solid_kmers), 1),
                                             bool) if len(res.solid_kmers)
                                     else np.zeros(1, bool)),
                         size_bits, n_hash, 0, "neighbor", k)
    bloom_bytes = np.asarray(words).view(np.uint8)
    bloom = NeighborBloom(bloom_bytes.tobytes(), size_bits, n_hash, k)

    dna_enc = _DnaEncoder(k, bloom)
    first_header = seqs[0].comment if seqs else ""
    hdr_enc = _HeaderEncoder(first_header)

    dna_blocks, hdr_blocks, qual_blocks = [], [], []
    dna_sizes, hdr_sizes = [], []
    for i in range(0, max(len(seqs), 1), reads_per_block):
        chunk = seqs[i:i + reads_per_block]
        if not chunk:
            break
        db = dna_enc.encode_block([s.data for s in chunk])
        hb = hdr_enc.encode_block([s.comment for s in chunk])
        dna_blocks.append(db)
        hdr_blocks.append(hb)
        dna_sizes += [len(db), len(chunk)]
        hdr_sizes += [len(hb), len(chunk)]
        if is_fastq:
            if lossless:
                quals = (s.quality for s in chunk)
            else:
                quals = (_smooth_quals(s.data, s.quality, bloom, k)
                         for s in chunk)
            qual_blocks.append(zlib.compress(
                ("".join(q + "\n" for q in quals)).encode("ascii"), 9))

    def _attrs(ds, **kv):
        # ASCII vlen strings: the reference's vendored libhdf5 rejects
        # UTF-8-cset attributes (H5Aread fails)
        str_t = h5py.string_dtype(encoding="ascii")
        for key, val in kv.items():
            ds.attrs.create(key, np.array([str(val).encode("ascii")],
                                          dtype=object), dtype=str_t)

    with h5py.File(path_out, "w") as f:
        def wbytes(name, data: bytes):
            return f.create_dataset(
                name, data=np.frombuffer(data, np.uint8))

        info = wbytes("metadata/infobyte",
                      bytes([(0 if is_fastq else 1)]))
        _attrs(info, type=("fastq" if is_fastq else "fasta"),
               header="true", version="1.1.0")
        wbytes("metadata/kmerSize", k.to_bytes(8, "little"))
        wbytes("metadata/readcount", len(seqs).to_bytes(8, "little"))
        total = sum(len(s.data) for s in seqs)
        wbytes("metadata/totalDnaSize", total.to_bytes(8, "little"))
        mx = max((len(s.data) for s in seqs), default=0)
        mn = min((len(s.data) for s in seqs), default=0)
        wbytes("metadata/maxSequenceSize", mx.to_bytes(4, "little"))
        wbytes("metadata/minSequenceSize", mn.to_bytes(4, "little"))

        bl = wbytes("leon/bloom", bloom_bytes.tobytes())
        _attrs(bl, size=size_bits, nb_hash=n_hash, kmer_size=k,
               type="neighbor")

        dict_bytes = dna_enc.encode_anchor_dict()
        ds = wbytes("leon/anchors/anchorsDict", dict_bytes)
        _attrs(ds, size=len(dict_bytes))
        wbytes("leon/anchors/size", len(dict_bytes).to_bytes(8, "little"))
        wbytes("leon/anchors/anchorAdress",
               len(dna_enc.anchor_list).to_bytes(4, "little"))

        import struct

        wbytes("leon/dna/nb_blocks", len(dna_sizes).to_bytes(8, "little"))
        wbytes("leon/dna/blocksizes",
               struct.pack(f"<{len(dna_sizes)}q", *dna_sizes))
        for i, b in enumerate(dna_blocks):
            ds = wbytes(f"leon/dna/dna_{i}", b)
            _attrs(ds, size=len(b))

        fh = first_header.encode("ascii")
        wbytes("leon/header/firstheadersize", len(fh).to_bytes(8, "little"))
        wbytes("leon/header/firstheader", fh if fh else b"\0")
        wbytes("leon/header/nb_blocks",
               len(hdr_sizes).to_bytes(8, "little"))
        wbytes("leon/header/blocksizes",
               struct.pack(f"<{len(hdr_sizes)}q", *hdr_sizes))
        for i, b in enumerate(hdr_blocks):
            ds = wbytes(f"leon/header/header_{i}", b)
            _attrs(ds, size=len(b))

        if is_fastq:
            for i, b in enumerate(qual_blocks):
                ds = wbytes(f"leon/qual/qual_{i}", b)
                _attrs(ds, size=len(b))
        else:
            f.create_group("leon/qual")

    return {
        "nb_reads": len(seqs),
        "nb_anchors": len(dna_enc.anchor_list),
        "compressed_bytes": sum(len(b) for b in dna_blocks)
        + sum(len(b) for b in hdr_blocks)
        + sum(len(b) for b in qual_blocks) + len(bloom_bytes),
    }


def _prop(ds, name: str) -> str:
    import numpy as np

    v = ds.attrs[name]
    if isinstance(v, (np.ndarray, list, tuple)) and len(v) == 1:
        v = v[0]
    return v.decode() if isinstance(v, bytes) else str(v)


def is_leon_ref_container(path: str) -> bool:
    """True if path is a reference .leon HDF5 container."""
    try:
        import h5py

        with h5py.File(path, "r") as f:
            return "leon" in f and "metadata" in f
    except Exception:
        return False


def leon_ref_decompress(path: str) -> bytes:
    """Decode a reference .leon file to the original FASTA/FASTQ bytes."""
    import h5py

    with h5py.File(path, "r") as f:
        info = f["metadata/infobyte"]
        is_fasta = _prop(info, "type") == "fasta"
        no_header = _prop(info, "header") != "true"
        k = int.from_bytes(f["metadata/kmerSize"][...].tobytes()[:4],
                           "little")

        # bloom (StorageTools::loadBloom: type/size/nb_hash attrs)
        bl = f["leon/bloom"]
        bloom = NeighborBloom(bl[...].tobytes(), int(_prop(bl, "size")),
                              int(_prop(bl, "nb_hash")), k)

        # anchor dict (Leon::decodeAnchorDict, Leon.cpp:1958-2000)
        anchors_grp = f["leon/anchors"]
        anchor_count = int.from_bytes(
            anchors_grp["anchorAdress"][...].tobytes(), "little")
        dict_data = anchors_grp["anchorsDict"][...].tobytes()
        dec = RangeDecoder(dict_data)
        model = Order0Model(5)
        anchors = []
        cur = 0
        nnt = 0
        for _ in range(anchor_count * k):
            c = dec.next_byte(model)
            cur = (cur << 2) | c
            nnt += 1
            if nnt == k:
                anchors.append(cur)
                cur = 0
                nnt = 0
            if len(anchors) == anchor_count:
                break

        # block tables
        dna_grp = f["leon/dna"]
        dna_sizes = dna_grp["blocksizes"][...].tobytes()
        import struct

        dna_blocks = struct.unpack(f"<{len(dna_sizes) // 8}q", dna_sizes)
        nb_blocks = len(dna_blocks) // 2

        headers_dec = None
        if not no_header:
            hdr_grp = f["leon/header"]
            fh_size = int.from_bytes(
                hdr_grp["firstheadersize"][...].tobytes()[:8], "little")
            first_header = hdr_grp["firstheader"][...].tobytes()[
                :fh_size].decode("ascii")
            headers_dec = _HeaderDecoder(first_header)

        dna_dec = _DnaDecoder(k, bloom, anchors)

        out = []
        read_id = 0
        for b in range(nb_blocks):
            seq_count = int(dna_blocks[2 * b + 1])
            reads = dna_dec.decode_block(
                f[f"leon/dna/dna_{b}"][...].tobytes(), seq_count)
            if headers_dec is not None:
                hdr_count = seq_count
                headers = headers_dec.decode_block(
                    f[f"leon/header/header_{b}"][...].tobytes(), hdr_count)
            else:
                headers = None
            if not is_fasta:
                quals = zlib.decompress(
                    f[f"leon/qual/qual_{b}"][...].tobytes()
                ).decode("ascii").splitlines()
            else:
                quals = None
            for i, r in enumerate(reads):
                if headers is not None:
                    tag = ">" if is_fasta else "@"
                    out.append(tag + headers[i] + "\n")
                else:
                    tag = "> " if is_fasta else "@ "
                    out.append(tag + str(read_id) + "\n")
                    read_id += 1
                out.append(r + "\n")
                if quals is not None:
                    out.append("+\n")
                    out.append(quals[i] + "\n")
        return "".join(out).encode("ascii")
