"""Synthetic genome and query batch, numpy only.

The port's own copy of the two generators of the repository's benchmark
configuration, so that a run of the port needs nothing of the JAX package:
the same seed gives the same text and the same patterns, element for
element (``tests/test_torch_synth.py`` holds them against the originals).
"""

from __future__ import annotations

import numpy as np


def synth_genome(n: int, seed: int = 0) -> np.ndarray:
    """``n`` characters over {0, 1, 2, 3} (int8) with drosophila-like
    repeat structure: about 70% fresh sequence, 25% segments copied from
    earlier in the text with about 1% mutations (dispersed repeats) and
    5% tandem repeats -- long approximate repeats are what makes a real
    genome hard to suffix-sort."""
    rng = np.random.default_rng(seed)
    out = np.empty(n, dtype=np.int8)
    pos = 0
    # seed the text with fresh sequence so early copies have a source
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
    sampled from the text (hits), 10% random (mostly misses) -- the
    reference batch protocol samples real reads; misses exercise the
    early-stop path."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - qlen, nq)
    idx = starts[:, None] + np.arange(qlen)[None, :]
    pats = text[idx]
    miss = rng.random(nq) < 0.10
    pats[miss] = rng.integers(0, 4, (int(miss.sum()), qlen), dtype=np.int8)
    return np.ascontiguousarray(pats, dtype=np.int8)
