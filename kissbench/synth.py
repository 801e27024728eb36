"""Frozen copies of the generators and the query packing the benchmark
feeds the program with.

``synth_genome`` and ``sample_patterns`` are copied from
``kiss_tpu_torch/utils/synth.py`` (themselves ``bench.py``'s), and
``pack_queries_2bit`` from ``kiss_tpu_torch/ops/pack.py``
(``np_pack_queries_2bit``). They are frozen here so that a change of the
program cannot move the inputs; ``tests/test_kissbench_frozen.py`` holds
each against its source element for element.
"""

from __future__ import annotations

import numpy as np

SYMS_PER_U32 = 16


def synth_genome(n: int, seed: int = 0) -> np.ndarray:
    """``n`` characters over {0, 1, 2, 3} (int8) with drosophila-like
    repeat structure: about 70% fresh sequence, 25% segments copied from
    earlier in the text with about 1% mutations (dispersed repeats) and
    5% tandem repeats."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.int8)
    boot = min(1 << 20, n)
    out[:boot] = rng.integers(0, 4, boot, dtype=np.int8)
    pos = boot
    while pos < n:
        r = rng.random()
        if r < 0.70 or pos < (1 << 21):
            seg = min(int(rng.integers(2_000, 30_000)), n - pos)
            out[pos : pos + seg] = rng.integers(0, 4, seg, dtype=np.int8)
        elif r < 0.95:
            # dispersed repeat: copy an earlier segment, ~1% mutations
            seg = min(int(rng.integers(500, 8_000)), n - pos, pos)
            start = int(rng.integers(0, pos - seg + 1))
            chunk = out[start : start + seg].copy()
            nmut = max(1, seg // 100)
            mi = rng.integers(0, seg, nmut)
            chunk[mi] = rng.integers(0, 4, nmut, dtype=np.int8)
            out[pos : pos + seg] = chunk
        else:
            # tandem repeat: short unit tiled
            unit = rng.integers(0, 4, int(rng.integers(2, 200)), dtype=np.int8)
            seg = min(int(rng.integers(200, 5_000)), n - pos)
            reps = -(-seg // len(unit))
            out[pos : pos + seg] = np.tile(unit, reps)[:seg]
        pos += seg
    return out


def sample_patterns(text: np.ndarray, nq: int, qlen: int,
                    seed: int = 7) -> np.ndarray:
    """``nq`` patterns of length ``qlen`` (int8 ``[nq, qlen]``): 90%
    sampled from the text (hits), 10% random (mostly misses)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - qlen, nq)
    idx = starts[:, None] + np.arange(qlen)[None, :]
    pats = text[idx]
    miss = rng.random(nq) < 0.10
    pats[miss] = rng.integers(0, 4, (int(miss.sum()), qlen), dtype=np.int8)
    return np.ascontiguousarray(pats, dtype=np.int8)


def pack_queries_2bit(queries: np.ndarray) -> np.ndarray:
    """int8/uint8 [Q, m] patterns -> uint32 [Q, ceil(m/16)], symbol j of
    query q at bits ``2 * (j % 16)`` of word ``j // 16`` (LSB-first)."""
    q = np.asarray(queries)
    if q.dtype != np.uint8:
        q = q.astype(np.uint8)
    Q, m = q.shape
    W = -(-m // SYMS_PER_U32)
    buf = np.zeros((Q, W * SYMS_PER_U32), np.uint32)
    buf[:, :m] = q
    buf = buf.reshape(Q, W, SYMS_PER_U32)
    shifts = (np.arange(SYMS_PER_U32, dtype=np.uint32) * 2)[None, None, :]
    return np.bitwise_or.reduce(buf << shifts, axis=2).astype(np.uint32)
