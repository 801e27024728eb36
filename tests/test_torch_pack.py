"""kiss_tpu_torch.ops.pack against kiss_tpu.ops.pack on the same numpy
inputs. Every output is an integer: comparisons are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.ops import pack as jpack
from kiss_tpu_torch.ops import pack

torch.set_num_threads(1)


def _j(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    """uint32 results of the port as int64 values (int32 bits widened)."""
    return pack.as_u32(x).numpy()


def _texts():
    rng = np.random.default_rng(3)
    dna = rng.integers(0, 4, 1001).astype(np.int8)  # n % 16 != 0
    high = rng.integers(-128, 128, 777).astype(np.int8)  # values >= 128
    return {"dna": dna, "int8_high": high}


@pytest.mark.parametrize("name", ["dna", "int8_high"])
def test_shifted_text_and_key_words(name):
    text = _texts()[name]
    tt, jt = torch.from_numpy(text), jnp.asarray(text)
    np.testing.assert_array_equal(
        _t(pack.shifted_text(tt, 40)), _j(jpack.shifted_text(jt, 40))
    )
    for alphabet, jalphabet in ((pack.DNA, jpack.DNA),
                                (pack.GENERAL, jpack.GENERAL)):
        for n_chars, off in ((1, 0), (8, 0), (13, 5), (20, 3)):
            got = pack.suffix_key_words(tt, n_chars, off, alphabet)
            want = jpack.suffix_key_words(jt, n_chars, off, jalphabet)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(_t(g), _j(w))


@pytest.mark.parametrize("n_chars,off", [(1, 0), (16, 0), (33, 7), (64, 0)])
def test_suffix_key_words_2bit(n_chars, off):
    text = _texts()["dna"]
    got = pack.suffix_key_words_2bit(torch.from_numpy(text), n_chars, off)
    want = jpack.suffix_key_words_2bit(jnp.asarray(text), n_chars, off)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_t(g), _j(w))


@pytest.mark.parametrize("cover", [1, 16, 64, 1000, 5000])
def test_clamped_len_and_fused_end_pos(cover):
    n = 1001
    np.testing.assert_array_equal(
        pack.clamped_suffix_len(n, cover, "cpu").numpy(),
        _j(jpack.clamped_suffix_len(n, cover)),
    )
    np.testing.assert_array_equal(
        pack.fused_end_pos(n, cover, "cpu").numpy(),
        _j(jpack.fused_end_pos(n, cover)),
    )


def _seed_text(kind, n):
    rng = np.random.default_rng(n)
    if kind == "dna":
        return rng.integers(0, 4, n).astype(np.int8)
    return rng.integers(-128, 128, n).astype(np.int8)  # every byte 0..255


@pytest.mark.parametrize("kind", ["dna", "bytes"])
@pytest.mark.parametrize("n", [1, 2, 15, 16, 63, 64, 65, 1000, 4097])
@pytest.mark.parametrize("seed_chars", [1, 15, 16, 17, 32, 48, 63, 64])
def test_seed_key_words_plain_is_the_packed_chain(seed_chars, n, kind):
    """K5's plain version, bit for bit the chain the seed sort ran before
    it: the raw 2-bit words and the fused end/position word through
    ``_pack_fields``, also for n below seed_chars and for bytes above 3
    (which spill into their neighbours' lanes); and ``decode_seed_keys``
    gives each row's position and clamped length back."""
    from kiss_tpu_torch.ops.suffix_sort import _pack_fields

    text = torch.from_numpy(_seed_text(kind, n))
    want, places = _pack_fields(
        [(w, 32, False) for w in pack.suffix_key_words_2bit(text, seed_chars)]
        + [(pack.fused_end_pos(n, seed_chars, "cpu"),
            max(n.bit_length(), 1), True)]
    )
    got = pack.seed_key_words_plain(text, seed_chars)
    assert got.dtype == torch.int32
    assert got.shape == (-(-seed_chars // 16) + 1, n + 1)
    assert torch.equal(got, want)
    assert places[-1][0] == 32 * (got.shape[0] - 1)  # the fused word's own
    # on a CPU tensor the wrapper is the plain version
    assert torch.equal(pack.seed_key_words(text, seed_chars), got)
    # the layout's one decoder, on the rows in any order
    perm = torch.randperm(n + 1, generator=torch.Generator().manual_seed(n))
    pos, length = pack.decode_seed_keys(got[:, perm], n, seed_chars)
    assert torch.equal(pos, perm)
    assert torch.equal(length, torch.clamp(n - perm, max=seed_chars))
    # the block form: the rows of a window, as the whole text's
    if n >= 16:
        start, rows = n // 3, n // 2
        part = pack.seed_key_words_plain(text[start:], seed_chars,
                                         start=start, n=n, rows=rows)
        assert torch.equal(part, got[:, start : start + rows])


def test_seed_key_words_refuses_what_it_does_not_take():
    text = torch.zeros(10, dtype=torch.int8)
    for chars in (0, 65):
        with pytest.raises(ValueError):
            pack.seed_key_words(text, chars)
    with pytest.raises(ValueError):
        pack.seed_key_words(text.to("meta"), 64)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1001])
def test_pack_dibits_u32(n):
    vals = np.random.default_rng(n).integers(0, 4, n).astype(np.int8)
    got = pack.pack_dibits_u32(torch.from_numpy(vals))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        _t(got), _j(jpack.pack_dibits_u32(jnp.asarray(vals)))
    )
    np.testing.assert_array_equal(
        pack.np_pack_dibits_u32(vals), jpack.np_pack_dibits_u32(vals)
    )


def test_popcount_u32():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64).astype(np.uint32)
    x[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    want = _j(jpack.popcount_u32(jnp.asarray(x)))
    # both storage forms: int32 bits and int64 values
    np.testing.assert_array_equal(
        pack.popcount_u32(torch.from_numpy(x.view(np.int32))).numpy(), want
    )
    np.testing.assert_array_equal(
        pack.popcount_u32(torch.from_numpy(x.astype(np.int64))).numpy(), want
    )


@pytest.mark.parametrize("sym", [0, 1, 2, 3])
def test_count_symbol_prefix_all_t(sym):
    """t over the whole range [0, 16], including the t = 16 branch."""
    rng = np.random.default_rng(sym)
    words = rng.integers(0, 2**32, 17 * 40, dtype=np.uint64).astype(np.uint32)
    t = np.tile(np.arange(17, dtype=np.uint32), 40)
    want = jpack.count_symbol_prefix(
        jnp.asarray(words), jnp.uint32(sym), jnp.asarray(t)
    )
    got = pack.count_symbol_prefix(
        torch.from_numpy(words.view(np.int32)), sym,
        torch.from_numpy(t.astype(np.int64)),
    )
    np.testing.assert_array_equal(got.numpy(), _j(want))


def test_np_pack_queries_2bit():
    q = np.random.default_rng(2).integers(0, 4, (50, 33)).astype(np.int8)
    np.testing.assert_array_equal(
        pack.np_pack_queries_2bit(q), jpack.np_pack_queries_2bit(q)
    )
