"""Helpers that check a run from outside its entry points: keep what a
function returns while a CLI call runs it, collect the log lines, record
the longest tensor a run makes, and sample a k-ordered suffix array on
the device. ``chip_smoke.py``, ``experiments/external_scale.py`` and the
tests use them."""

from __future__ import annotations

import logging

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class Kept:
    """Wraps ``module.name`` while in a ``with`` block: every value it
    returns is kept in ``values``. Keyword arguments given here are added
    to each call (for example a ``split`` dict the function fills)."""

    def __init__(self, module, name, **extra):
        self.module, self.name, self.extra = module, name, extra
        self.inner = getattr(module, name)
        self.values = []

    def __enter__(self):
        def keep(*args, **kwargs):
            self.values.append(self.inner(*args, **kwargs, **self.extra))
            return self.values[-1]

        setattr(self.module, self.name, keep)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


class LogLines(logging.Handler):
    """Collects log messages (the CLI's propagate to the root logger)."""

    def __init__(self):
        super().__init__(logging.DEBUG)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def value(self, prefix: str) -> str:
        """The rest of the last line that starts with ``prefix``; raises
        if there is none."""
        hits = [m[len(prefix):] for m in self.lines if m.startswith(prefix)]
        if not hits:
            raise RuntimeError(f"no log line starting {prefix!r}")
        return hits[-1]


class LongestTensor(TorchDispatchMode):
    """While active (``with LongestTensor() as rec``), ``rec.longest`` is
    the largest dimension of every tensor any op has produced: the
    residency check of the mesh pipeline, which must make no tensor as
    long as the text on any shard."""

    def __init__(self):
        super().__init__()
        self.longest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.dim():
                self.longest = max(self.longest, max(t.shape))
        return out


def check_k_sorted_sample(text_dev, sa, k: int, samples: int) -> None:
    """Raise unless the SA (int64, on ``text_dev``'s device) is a
    permutation of 0..n and ``samples`` random adjacent rows are in order
    by their first k characters (a suffix that ends sorts first), ties by
    position."""
    n = text_dev.shape[0]
    N = n + 1
    if sa.shape[0] != N:
        raise RuntimeError(f"SA length {sa.shape[0]} != {N}")
    check_permutation(sa)
    padded = torch.full((n + k,), -1, dtype=torch.int16, device=sa.device)
    padded[:n] = text_dev.to(torch.int16)
    g = torch.Generator(device=sa.device).manual_seed(5)
    r = torch.randint(0, N - 1, (samples,), device=sa.device, generator=g)
    a, b = sa[r], sa[r + 1]
    cols = torch.arange(k, device=sa.device)
    wa, wb = padded[a[:, None] + cols], padded[b[:, None] + cols]
    diff = wa != wb
    first = torch.argmax(diff.to(torch.int32), dim=1)
    rows = torch.arange(samples, device=sa.device)
    ok = torch.where(
        diff.any(dim=1), wa[rows, first] < wb[rows, first], a < b
    )
    if not bool(ok.all()):
        raise RuntimeError(f"k={k} SA sample out of order")


def check_permutation(perm, chunk: int = 1 << 28) -> None:
    """Raise unless ``perm`` (int64 [N]) holds every one of 0..N-1: each
    entry in range and every position seen, by a bitmap filled ``chunk``
    entries at a time (a byte a position beside the input)."""
    N = perm.shape[0]
    seen = torch.zeros(N, dtype=torch.bool, device=perm.device)
    for lo in range(0, N, chunk):
        p = perm[lo : lo + chunk]
        if bool((p < 0).any()) or bool((p >= N).any()):
            raise RuntimeError("permutation entry out of range")
        seen[p] = True
    if not bool(seen.all()):
        raise RuntimeError("not a permutation: a position is missing")


def check_stable_sort(keys, sorted_keys, perm, chunk: int = 1 << 28) -> None:
    """Raise unless (``sorted_keys``, ``perm``) is the stable sort of
    ``keys`` (int32 [W, N] holding uint32 bits, word 0 most significant;
    ``perm`` int64 [N]): ``perm`` is a permutation of 0..N-1
    (:func:`check_permutation`), ``sorted_keys`` is
    ``keys[:, perm]``, the keys do not decrease, and equal keys keep their
    positions in ascending order. Works on ``chunk`` rows at a time, so
    its temporaries are the chunk's, not N's."""
    from kiss_tpu_torch.ops.pack import as_u32

    W, N = keys.shape
    if sorted_keys.shape != keys.shape or perm.shape != (N,):
        raise RuntimeError("sorted keys or permutation of the wrong shape")
    check_permutation(perm, chunk)
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        p = perm[lo:hi]
        if not torch.equal(sorted_keys[:, lo:hi], keys[:, p]):
            raise RuntimeError(f"sorted keys are not keys[:, perm] in rows "
                               f"[{lo}, {hi})")
        # the pairs (j, j + 1) for j in [lo, hi), the last one across
        top = min(hi + 1, N)
        a = as_u32(sorted_keys[:, lo:top])
        less = torch.zeros(top - lo - 1, dtype=torch.bool, device=a.device)
        equal = torch.ones_like(less)
        for w in range(W):
            x, y = a[w, :-1], a[w, 1:]
            less |= equal & (x < y)
            equal &= x == y
        q = perm[lo:top]
        if not bool((less | (equal & (q[:-1] < q[1:]))).all()):
            raise RuntimeError(f"keys out of order, or equal keys out of "
                               f"position order, in rows [{lo}, {top})")
