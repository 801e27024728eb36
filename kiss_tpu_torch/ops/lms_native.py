"""`-s LMS_INDUCED`: the reference's LMS + induced-sort core as a
native HOST strategy.

Copy of ``kiss_tpu.ops.lms_native`` for the PyTorch port. The
reference's central work reduction -- classify suffix types, sort only
the ~n/3 LMS suffixes by their first k characters, then induce every L-
and S-type suffix with two bucket-cursor scans (reference:
include/biovoltron/algo/sort/kiss_common.hpp:40-579,
kiss1_core.hpp:23-145) -- is host-shaped: sequential scans with
data-dependent cursors. Like the reference, it therefore runs as native
C++ (csrc/kiss_lms.cpp, written from the classic SA-IS induction
scheme), beside the device strategies PARALLEL_SORTING and
PREFIX_DOUBLING. It uses no device: ``-t`` maps to OpenMP threads for the
LMS sort stage, and the CLI never routes it out of core.

Contract: the REFERENCE's k-ordered contract (tie-group order
unspecified; conformance is group-level, like the reference binary's
own two strategies against each other). With ``k = -1`` the output is
the unique full suffix array, bit-identical to the device strategies.
"""

from __future__ import annotations

import numpy as np

from kiss_tpu_torch.utils import native


class LmsSorter:
    """Facade with the same static contract as the device sorters
    (ops/suffix_sort.py `_SorterBase`; reference: kiss1_sorter.hpp)."""

    SA_dtype = np.uint32
    strategy = "lms"

    @staticmethod
    def prepare_aligned_ref(seq) -> np.ndarray:
        return np.ascontiguousarray(seq, dtype=np.int8)

    @classmethod
    def _sort(cls, ref, k, num_threads) -> np.ndarray:
        ref = cls.prepare_aligned_ref(ref)
        if num_threads:
            native.set_threads(int(num_threads))
        sa = native.lms_induced_sort(ref, int(k))
        if sa is None:
            raise RuntimeError(
                "LMS_INDUCED requires the native library "
                "(`make -C csrc`); no C++ toolchain found. Use "
                "PARALLEL_SORTING or PREFIX_DOUBLING instead."
            )
        if len(ref) + 1 <= np.iinfo(np.uint32).max:
            return sa.astype(np.uint32)
        return sa

    @classmethod
    def get_suffix_array_dna(cls, ref, k=256, num_threads=None) -> np.ndarray:
        return cls._sort(ref, k, num_threads)

    @classmethod
    def get_suffix_array(cls, ref, k=256, num_threads=None) -> np.ndarray:
        return cls._sort(ref, k, num_threads)
