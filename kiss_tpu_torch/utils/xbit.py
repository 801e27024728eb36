"""Packed N-bit element containers (XbitVector family).

Copy of ``kiss_tpu.utils.xbit`` for the PyTorch port (numpy only).

Host-side counterpart of the reference's proxy-reference container
``XbitVector<N, Block>`` (reference: include/biovoltron/container/
xbit_vector.hpp:354-1343) with the aliases ``DibitVector`` (2-bit,
xbit_vector.hpp:1410), ``QuadbitVector`` (4-bit, xbit_vector.hpp:1423)
and ``TypeVector`` (1-bit flags, reference: include/biovoltron/algo/
sort/structs.hpp:187-188).

Same storage contract as the reference: elements packed LSB-first into
unsigned blocks (default uint8), so ``bytes(DibitVector([...]))`` is
byte-identical to the reference container's serialized payload and to
the ``.fmi`` BWT section (utils/serializer.py shares the layout, and
:func:`kiss_tpu_torch.ops.pack.np_pack_dibits_u32` is the same bits viewed
through little-endian uint32).

Design departure: the reference exposes per-element proxy references
(``XbitReference`` masked read-modify-write, xbit_vector.hpp:11-66)
because C++ iterators demand lvalues; here bulk NumPy fancy indexing is
the native idiom -- ``vec[idx_array]`` / ``vec[idx_array] = values``
are vectorized, and scalar access works too.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "XbitVector",
    "DibitVector",
    "QuadbitVector",
    "TypeVector",
]


class XbitVector:
    """Dynamic array of ``n_bits``-wide unsigned elements packed
    LSB-first into ``block`` words (default uint8, as the reference's
    default template argument)."""

    def __init__(self, values=None, *, n_bits: int, block=np.uint8):
        block = np.dtype(block)
        bits_per_block = 8 * block.itemsize
        if n_bits < 1 or bits_per_block % n_bits:
            raise ValueError(f"n_bits={n_bits} must divide {bits_per_block}")
        self.n_bits = n_bits
        self.block = block
        self.epb = bits_per_block // n_bits  # elements per block
        self.mask = (1 << n_bits) - 1
        self._size = 0
        self._blocks = np.zeros(0, dtype=block)
        if values is not None:
            self.extend(values)

    # -- capacity ---------------------------------------------------------

    def __len__(self) -> int:
        return self._size

    def num_blocks(self) -> int:
        """Blocks in use (reference extra, xbit_vector.hpp ``num_blocks``)."""
        return -(-self._size // self.epb)

    def data(self) -> np.ndarray:
        """The underlying block array, trimmed to blocks in use
        (reference extra ``data()``). A view -- mutations show through."""
        return self._blocks[: self.num_blocks()]

    def _reserve(self, n_elems: int) -> None:
        need = -(-n_elems // self.epb)
        if need > len(self._blocks):
            grown = np.zeros(max(need, 2 * len(self._blocks)), self.block)
            grown[: len(self._blocks)] = self._blocks
            self._blocks = grown

    # -- element access ---------------------------------------------------

    def _normalize_index(self, i):
        if isinstance(i, slice):
            return np.arange(*i.indices(self._size))
        idx = np.asarray(i)
        if (idx < -self._size).any() or (idx >= self._size).any():
            raise IndexError(f"index out of range for size {self._size}")
        return np.where(idx < 0, idx + self._size, idx)

    def __getitem__(self, i):
        scalar = np.isscalar(i) or (
            isinstance(i, (np.ndarray, np.integer)) and np.ndim(i) == 0
        )
        idx = self._normalize_index(i)
        blk = self._blocks[idx // self.epb]
        off = (idx % self.epb) * self.n_bits
        out = (blk >> off.astype(self.block)) & self.block.type(self.mask)
        return out[()] if scalar else out

    def __setitem__(self, i, values) -> None:
        idx = self._normalize_index(i)
        vals = np.broadcast_to(
            np.asarray(values, dtype=self.block), np.shape(idx)
        )
        if (vals > self.mask).any():
            raise ValueError(f"value exceeds {self.n_bits}-bit range")
        idx = np.atleast_1d(idx)
        vals = np.atleast_1d(vals)
        if idx.size > 1:
            # duplicate element indices: keep only the last write (the
            # reference's sequential proxy writes end with the last value)
            _, last_rev = np.unique(idx[::-1], return_index=True)
            keep = idx.size - 1 - last_rev
            idx, vals = idx[keep], vals[keep]
        blk = idx // self.epb
        off = ((idx % self.epb) * self.n_bits).astype(self.block)
        # distinct elements may share a block: clear+or via ufunc.at
        # (unbuffered), lanes never clash after the dedup above
        np.bitwise_and.at(
            self._blocks, blk, ~(self.block.type(self.mask) << off)
        )
        np.bitwise_or.at(self._blocks, blk, vals << off)

    # -- modifiers --------------------------------------------------------

    def append(self, value) -> None:
        self._reserve(self._size + 1)
        self._size += 1
        self[self._size - 1] = value

    def extend(self, values) -> None:
        vals = np.asarray(list(values) if not hasattr(values, "__len__")
                          else values)
        if vals.size == 0:
            return
        start = self._size
        self._reserve(start + vals.size)
        self._size += vals.size
        self[np.arange(start, self._size)] = vals

    def pop(self):
        if not self._size:
            raise IndexError("pop from empty XbitVector")
        v = self[self._size - 1]
        self[self._size - 1] = 0  # keep trailing bits zero (serialization)
        self._size -= 1
        return v

    def clear(self) -> None:
        self._size = 0
        self._blocks = np.zeros(0, dtype=self.block)

    def flip(self) -> None:
        """Invert every element (reference extra ``flip()``): complement
        all blocks, then re-zero the tail padding."""
        nb = self.num_blocks()
        self._blocks[:nb] = ~self._blocks[:nb]
        tail = self._size % self.epb
        if tail:
            keep = self.block.type((1 << (tail * self.n_bits)) - 1)
            self._blocks[nb - 1] &= keep

    # -- conversions ------------------------------------------------------

    def to_array(self) -> np.ndarray:
        """Unpacked elements as a block-dtype array."""
        return self[np.arange(self._size)] if self._size else np.zeros(
            0, self.block
        )

    def __bytes__(self) -> bytes:
        """Packed payload, LSB-first within blocks, little-endian blocks:
        the reference container's memory image (what Serializer writes,
        reference: utility/archive/serializer.hpp:69-139)."""
        return self.data().astype(self._blocks.dtype.newbyteorder("<"),
                                  copy=False).tobytes()

    @classmethod
    def from_bytes(cls, payload: bytes, size: int, *, n_bits: int,
                   block=np.uint8) -> "XbitVector":
        v = cls(n_bits=n_bits, block=block)
        v._blocks = np.frombuffer(payload, dtype=block).copy()
        v._size = size
        if v.num_blocks() > len(v._blocks):
            raise ValueError("payload too short for size")
        return v

    def __iter__(self):
        return iter(self.to_array())

    def __eq__(self, other) -> bool:
        if not isinstance(other, XbitVector):
            return NotImplemented
        return (
            self.n_bits == other.n_bits
            and self._size == other._size
            and bool(np.array_equal(self.to_array(), other.to_array()))
        )

    def __repr__(self) -> str:
        head = ", ".join(str(x) for x in self.to_array()[:16])
        more = ", ..." if self._size > 16 else ""
        return (f"{type(self).__name__}(n_bits={self.n_bits}, "
                f"size={self._size}, [{head}{more}])")


def DibitVector(values=None, block=np.uint8) -> XbitVector:
    """2-bit elements, 4 per byte (reference: xbit_vector.hpp:1410)."""
    return XbitVector(values, n_bits=2, block=block)


def QuadbitVector(values=None, block=np.uint8) -> XbitVector:
    """4-bit elements, 2 per byte (reference: xbit_vector.hpp:1423)."""
    return XbitVector(values, n_bits=4, block=block)


def TypeVector(values=None, block=np.uint8) -> XbitVector:
    """1-bit flags (reference: algo/sort/structs.hpp:187-188)."""
    return XbitVector(values, n_bits=1, block=block)
