"""Byte-compatible serializer for reference archive files (``.fmi``).

The reference serializes each contiguous container as a ``size_t`` element
count followed by the raw memory image, and writes nothing at all for empty
containers (reference: include/biovoltron/utility/archive/serializer.hpp:
92-138). Sub-byte containers are stored via their block memory:

  - ``DibitVector<uint8_t>``: 2-bit elements, 4 per byte, LSB-first within
    the byte (reference: include/biovoltron/container/xbit_vector.hpp:11-66,
    ``XbitReference`` shift = offset * N).
  - ``XbitVector<1, uint64_t>``: 1-bit elements, LSB-first within 64-bit
    little-endian blocks.

This module reproduces those layouts exactly with vectorized numpy
packing, so archives round-trip bit-for-bit against the reference format.
"""

from __future__ import annotations

import struct

import numpy as np

_SIZE_T = struct.Struct("<Q")


# ---------------------------------------------------------------------------
# bit packing (layouts match XbitReference: element i lives in block
# i // per_block at bit offset (i % per_block) * N, LSB-first)
# ---------------------------------------------------------------------------


def pack_dibits(values: np.ndarray) -> np.ndarray:
    """Pack 2-bit values (int8/uint8, 0..3) into uint8 blocks, 4/byte."""
    values = np.asarray(values, dtype=np.uint8)
    n = values.shape[0]
    padded = np.zeros((n + 3) // 4 * 4, dtype=np.uint8)
    padded[:n] = values
    q = padded.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(
        np.uint8
    )


def unpack_dibits(blocks: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_dibits`; returns int8 values of length n."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    out = np.empty(blocks.shape[0] * 4, dtype=np.uint8)
    out[0::4] = blocks & 3
    out[1::4] = (blocks >> 2) & 3
    out[2::4] = (blocks >> 4) & 3
    out[3::4] = (blocks >> 6) & 3
    return out[:n].astype(np.int8)


def pack_bits_u64(values: np.ndarray) -> np.ndarray:
    """Pack booleans into uint64 blocks, LSB-first (vector<bool> layout)."""
    values = np.asarray(values, dtype=bool)
    n = values.shape[0]
    nblocks = (n + 63) // 64
    padded = np.zeros(nblocks * 64, dtype=np.uint8)
    padded[:n] = values
    # little bit order within bytes + little-endian bytes within u64 ==
    # LSB-first within the 64-bit block
    return np.packbits(padded, bitorder="little").view(np.uint64)


def unpack_bits_u64(blocks: np.ndarray, n: int) -> np.ndarray:
    blocks = np.asarray(blocks, dtype=np.uint64)
    bits = np.unpackbits(blocks.view(np.uint8), bitorder="little")
    return bits[:n].astype(bool)


# ---------------------------------------------------------------------------
# size-prefixed raw save/load (reference: serializer.hpp:94-138)
# ---------------------------------------------------------------------------


def save_range(fout, count: int, raw: bytes | np.ndarray) -> None:
    """Write one container: ``size_t count`` then the raw block bytes.

    Matches ``Serializer::save`` including the quirk that an empty
    container writes nothing at all (reference: serializer.hpp:97-98).
    """
    if count == 0:
        return
    fout.write(_SIZE_T.pack(count))
    if isinstance(raw, np.ndarray):
        raw = np.ascontiguousarray(raw).tobytes()
    fout.write(raw)


def load_range(fin, bytes_for_count) -> tuple[int, bytes]:
    """Read one container: returns (count, raw bytes).

    ``bytes_for_count`` maps the element count to the stored byte length
    (the reference derives it from the container's block layout,
    serializer.hpp:71-80).
    """
    hdr = fin.read(_SIZE_T.size)
    if len(hdr) != _SIZE_T.size:
        raise EOFError("truncated archive: missing size header")
    (count,) = _SIZE_T.unpack(hdr)
    nbytes = bytes_for_count(count)
    raw = fin.read(nbytes)
    if len(raw) != nbytes:
        raise EOFError("truncated archive: missing payload")
    return count, raw


def dibit_bytes(count: int) -> int:
    """Stored bytes for a DibitVector<uint8_t> of ``count`` elements."""
    return (count + 3) // 4


def bit_u64_bytes(count: int) -> int:
    """Stored bytes for an XbitVector<1, uint64_t> of ``count`` elements."""
    return (count + 63) // 64 * 8


def scalar_bytes(itemsize: int):
    return lambda count: count * itemsize
