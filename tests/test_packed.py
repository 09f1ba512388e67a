"""Packed transfer format: pack/unpack roundtrips, extract_kmers_packed
equality with extract_kmers, and the native C++ packed batcher vs the
host numpy packer. The packed format (2 bits/base + 1 validity bit) is
the production host->device transfer path.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from gatb_core_tpu.ops.bitpack import pack_batch_np, ascii_to_codes_np
from gatb_core_tpu.ops.kmer_ops import (
    extract_kmers, extract_kmers_packed, pack_words, pack_valid,
    unpack_codes, unpack_valid,
)


def _random_batch(rng, B, L, with_invalid=True):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    valid = np.ones((B, L), bool)
    if with_invalid:
        valid &= rng.random((B, L)) > 0.03
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    pos = np.arange(L)[None, :]
    valid &= pos < lengths[:, None]
    return codes, valid, lengths


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes, valid, _ = _random_batch(rng, 16, 75)
    w = pack_words(jnp.asarray(codes))
    v = pack_valid(jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(unpack_codes(w, 75)), codes)
    np.testing.assert_array_equal(np.asarray(unpack_valid(v, 75)), valid)
    # host packer agrees with the device packer
    wn, vn = pack_batch_np(codes, valid)
    np.testing.assert_array_equal(wn, np.asarray(w))
    np.testing.assert_array_equal(vn, np.asarray(v))


@pytest.mark.parametrize("k,L", [(11, 48), (31, 150), (63, 150)])
def test_extract_packed_equals_unpacked(k, L):
    rng = np.random.default_rng(k)
    codes, valid, lengths = _random_batch(rng, 32, L)
    ref = extract_kmers(jnp.asarray(codes), jnp.asarray(valid),
                        jnp.asarray(lengths), k)
    wn, vn = pack_batch_np(codes, valid)
    got = extract_kmers_packed(jnp.asarray(wn), jnp.asarray(vn),
                               jnp.asarray(lengths), k, L)
    np.testing.assert_array_equal(np.asarray(got.valid),
                                  np.asarray(ref.valid))
    rv, gv = np.asarray(ref.valid), np.asarray(got.valid)
    np.testing.assert_array_equal(np.asarray(got.kmers)[gv],
                                  np.asarray(ref.kmers)[rv])
    np.testing.assert_array_equal(np.asarray(got.minimizer)[gv],
                                  np.asarray(ref.minimizer)[rv])


def test_native_packed_batcher_matches_numpy(tmp_path):
    from gatb_core_tpu.native import available, NativeBatcher

    if not available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(3)
    nts = np.array(list("ACTGN"))
    path = tmp_path / "r.fa"
    with open(path, "w") as f:
        for i in range(300):
            n = int(rng.integers(40, 200))
            f.write(f">s{i}\n" +
                    "".join(nts[rng.integers(0, 5, n)]) + "\n")
    k, B, L = 31, 64, 128
    plain = list(NativeBatcher(str(path), k, B, L))
    packed = list(NativeBatcher(str(path), k, B, L).iter_packed())
    assert len(plain) == len(packed)
    for (c, v, ln, r), (w, vm, ln2, r2) in zip(plain, packed):
        assert r == r2
        np.testing.assert_array_equal(ln, ln2)
        wn, vn = pack_batch_np(c, v)
        np.testing.assert_array_equal(w, wn)
        np.testing.assert_array_equal(vm, vn)
