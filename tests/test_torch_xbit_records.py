"""The port's copies of the numpy-only host modules ``utils/xbit.py`` and
``utils/records.py``: the cases of tests/test_xbit.py and
tests/test_records_native.py on the port, each also held against
kiss_tpu's module on the same input (equal bytes, equal lines)."""

import dataclasses

import numpy as np
import pytest

from kiss_tpu.utils import records as jrecords
from kiss_tpu.utils import xbit as jxbit
from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.utils import records
from kiss_tpu_torch.utils.xbit import (
    DibitVector,
    QuadbitVector,
    TypeVector,
    XbitVector,
)


@pytest.mark.parametrize("n_bits", [1, 2, 4, 8])
def test_roundtrip_random(n_bits):
    rng = np.random.default_rng(n_bits)
    vals = rng.integers(0, 1 << n_bits, 1000).astype(np.uint8)
    v = XbitVector(vals, n_bits=n_bits)
    assert len(v) == 1000
    np.testing.assert_array_equal(v.to_array(), vals)
    assert v[17] == vals[17] and v[-1] == vals[-1]
    idx = rng.integers(0, 1000, 50)
    np.testing.assert_array_equal(v[idx], vals[idx])
    np.testing.assert_array_equal(v[10:20], vals[10:20])
    v[idx] = 0
    vals[idx] = 0
    np.testing.assert_array_equal(v.to_array(), vals)
    w = XbitVector.from_bytes(bytes(v), len(v), n_bits=n_bits)
    assert w == v
    assert bytes(v) == bytes(jxbit.XbitVector(vals, n_bits=n_bits))


def test_dibit_layout_matches_device_words():
    """DibitVector bytes viewed little-endian == the port's packed words
    (the .fmi BWT section layout)."""
    vals = np.random.default_rng(0).integers(0, 4, 160).astype(np.uint8)
    v = DibitVector(vals)
    words = pack.np_pack_dibits_u32(vals)
    assert bytes(v).ljust(words.nbytes, b"\0") == words.astype("<u4").tobytes()


def test_append_pop_flip():
    v = DibitVector()
    for x in (0, 1, 2, 3, 1):
        v.append(x)
    assert len(v) == 5 and v.num_blocks() == 2
    assert v.pop() == 1 and len(v) == 4
    v.flip()  # 2-bit complement: 0<->3, 1<->2
    np.testing.assert_array_equal(v.to_array(), [3, 2, 1, 0])
    assert bytes(v) == bytes(DibitVector([3, 2, 1, 0]))


def test_typevector_flags():
    flags = np.array([1, 0, 0, 1, 1, 0, 1, 0, 1], dtype=np.uint8)
    t = TypeVector(flags)
    np.testing.assert_array_equal(t.to_array(), flags)
    assert t.num_blocks() == 2
    b0 = bytes(t)[0]  # LSB-first: bit i of byte 0 is flags[i]
    assert [(b0 >> i) & 1 for i in range(8)] == flags[:8].tolist()
    assert bytes(t) == bytes(jxbit.TypeVector(flags))


def test_quadbit_and_errors():
    q = QuadbitVector([15, 0, 7])
    assert list(q) == [15, 0, 7]
    with pytest.raises(ValueError):
        q[0] = 16
    with pytest.raises(IndexError):
        q[3]
    with pytest.raises(ValueError):
        XbitVector(n_bits=3)  # 3 does not divide 8


def test_duplicate_index_writes_last_wins():
    v = DibitVector([0, 0, 0, 0])
    v[np.array([1, 1, 1])] = np.array([3, 2, 1])
    assert v[1] == 1  # last write wins, not the bitwise OR (3|2|1)
    v[np.array([2, 3, 2])] = np.array([1, 1, 2])
    np.testing.assert_array_equal(v.to_array(), [0, 1, 2, 1])


@dataclasses.dataclass
class Bed:
    chrom: str
    start: int
    end: int
    tags: list


def test_record_roundtrip(tmp_path):
    rows = [Bed("chr1", 10, 20, ["a", "b"]), Bed("chr2", 5, 9, [])]
    p, jp = str(tmp_path / "x.bed"), str(tmp_path / "j.bed")
    records.write_records(p, rows, header=["#hdr line"])
    jrecords.write_records(jp, rows, header=["#hdr line"])
    with open(p) as a, open(jp) as b:
        assert a.read() == b.read()
    header, got = records.read_records(Bed, p)
    assert header == ["#hdr line"]
    assert got[0].chrom == "chr1" and got[0].start == 10
    assert got[0].tags == ["a", "b"]
    assert got[1].end == 9
    assert [records.to_line(r) for r in got] == [
        jrecords.to_line(r) for r in jrecords.read_records(Bed, jp)[1]
    ]
