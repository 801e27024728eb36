"""The host-side plans of the port's two sorts, which decide what the CUDA
kernels are launched on, and the plain versions the card tests trust:

- ``radix_sort.pass_plan`` (K1): which (word, byte) digit passes run, in
  which order, and where the next word rides along, replayed in numpy;
- ``micro_kernels.tile_sort_schedule`` (P3): the launches of the in-tile
  bitonic sort, held to the network step by step and replayed with
  ``one_stage_plain`` against ``np.lexsort`` and the TPU probe
  (``experiments/micro_pallas.tile_sort`` in Pallas interpret mode);
- ``radix_sort_words_plain`` against ``jax.lax.sort(..., num_keys=W,
  is_stable=True)`` on the key sets that stress the pass kernel's edges.

All values are integers: tolerance 0 everywhere."""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kiss_tpu_torch.experiments import micro_kernels as tprobe
from kiss_tpu_torch.ops.radix_sort import (
    DigitPass,
    pass_plan,
    radix_sort_words_plain,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE = 8192  # keys a tile of K1's pass kernel holds


# ------------------------------------------------------------ K1 pass plan


def _counts(keys):
    """counts[w][b][d] of uint32 keys [W, N], as the counting kernel gives."""
    return np.stack([
        np.stack([np.bincount((word >> (8 * b)) & 0xFF, minlength=256)
                  for b in range(4)])
        for word in keys
    ])


def _replay(keys, plan):
    """The permutation the plan's passes give, run as the wrapper runs
    them: the first word as it is, a stable pass per entry on the current
    key, and the key replaced by ``next_word`` gathered through the index
    on a word's last pass. Before every pass the current key must be the
    planned word in the current order."""
    n = keys.shape[1]
    idx = np.arange(n)
    if not plan:
        return idx
    cur = keys[plan[0].word].copy()
    for p in plan:
        np.testing.assert_array_equal(cur, keys[p.word][idx])
        order = np.argsort((cur >> (8 * p.byte)) & 0xFF, kind="stable")
        idx = idx[order]
        cur = cur[order] if p.next_word is None else keys[p.next_word][idx]
    return idx


def _lexsort(keys):
    n = keys.shape[1]
    return np.lexsort([np.arange(n)] + [keys[w] for w in
                                        range(keys.shape[0] - 1, -1, -1)])


def _plan_keys(kind, w, n=3000, seed=0):
    rng = np.random.default_rng(seed)
    keys = np.full((w, n), 0x0A0B0C0D, dtype=np.uint32)
    if kind == "random":
        keys = rng.integers(0, 2**32, (w, n), dtype=np.uint64).astype(
            np.uint32)
    elif kind == "middle_byte":  # byte 1 of the middle word alone varies
        keys[w // 2] = 0x0A0B000D | (
            rng.integers(0, 256, n).astype(np.uint32) << 8)
    elif kind == "skip_word":  # a constant word between two sorted ones
        keys[0] = rng.integers(0, 4, n).astype(np.uint32) << 24
        keys[-1] = rng.integers(0, 2**16, n).astype(np.uint32)
    elif kind == "ties":
        keys = rng.integers(0, 3, (w, n)).astype(np.uint32)
    else:
        assert kind == "constant"
    return keys


def test_pass_plan_all_bytes_constant_is_empty_and_identity():
    keys = _plan_keys("constant", 5)
    plan = pass_plan(_counts(keys), keys.shape[1])
    assert plan == []
    np.testing.assert_array_equal(_replay(keys, plan), np.arange(3000))
    assert pass_plan(np.zeros((3, 4, 256), np.int64), 0) == []


def test_pass_plan_one_byte_in_the_middle_word():
    keys = _plan_keys("middle_byte", 5)
    plan = pass_plan(_counts(keys), keys.shape[1])
    assert plan == [DigitPass(word=2, byte=1, next_word=None)]
    np.testing.assert_array_equal(_replay(keys, plan), _lexsort(keys))


def test_pass_plan_skips_a_constant_word_between_two_sorted_ones():
    keys = _plan_keys("skip_word", 3)
    plan = pass_plan(_counts(keys), keys.shape[1])
    # word 2 has two live bytes; its last pass brings in word 0, not the
    # constant word 1; word 0 has one live byte (its top one)
    assert plan == [DigitPass(2, 0, None), DigitPass(2, 1, 0),
                    DigitPass(0, 3, None)]
    np.testing.assert_array_equal(_replay(keys, plan), _lexsort(keys))


@pytest.mark.parametrize("kind", ["random", "ties", "skip_word"])
@pytest.mark.parametrize("w", [1, 2, 5, 8, 9])
def test_pass_plan_replayed_equals_lexsort(kind, w):
    keys = _plan_keys(kind, w, seed=w)
    plan = pass_plan(_counts(keys), keys.shape[1])
    live = {(p.word, p.byte) for p in plan}
    for word in range(w):
        for b in range(4):
            digit = (keys[word] >> (8 * b)) & 0xFF
            assert ((word, b) in live) == (digit.min() != digit.max())
    # least significant word first, bytes low to high, one fused gather a
    # word boundary, none on the last pass
    order = [(p.word, p.byte) for p in plan]
    assert order == sorted(order, key=lambda wb: (-wb[0], wb[1]))
    boundaries = sum(plan[i].word != plan[i + 1].word
                     for i in range(len(plan) - 1))
    assert sum(p.next_word is not None for p in plan) == boundaries
    assert not plan or plan[-1].next_word is None
    np.testing.assert_array_equal(_replay(keys, plan), _lexsort(keys))


# ---------------------------------------------------------- P3 schedule


def _network(T):
    return [(size, d) for size in (2 << i for i in range(T.bit_length() - 1))
            for d in (size >> (j + 1) for j in range(size.bit_length() - 1))]


@pytest.mark.parametrize("log2_t", range(7, 21))
def test_tile_sort_schedule_is_the_network(log2_t):
    T = 1 << log2_t
    launches = tprobe.tile_sort_schedule(T)
    steps = [s for launch in launches for s in launch.steps]
    assert len(steps) == log2_t * (log2_t + 1) // 2
    assert steps == _network(T)  # each step once, in network order
    assert launches[0].kind == "local_full"
    chunk = tprobe.SORT_CHUNK
    for launch in launches:
        sizes = {size for size, _ in launch.steps}
        ds = [d for _, d in launch.steps]
        if launch.kind == "wide":
            assert len(sizes) == 1 and min(ds) >= chunk
            assert 1 <= len(ds) <= tprobe.WIDE_STEPS
            assert ds == [ds[0] >> i for i in range(len(ds))]
        elif launch.kind == "local_merge":
            assert len(sizes) == 1 and min(sizes) > chunk
            assert ds == [chunk >> (i + 1) for i in range(13)]
        else:
            assert launch is launches[0] and max(ds) < chunk
            assert max(sizes) == min(T, chunk)
    # two trips a merge size above a chunk while its wide steps fit one
    # launch (T <= 256K), never a launch per step
    if T <= 1 << 18:
        assert len(launches) == 1 + 2 * max(0, log2_t - 13)
    assert len(tprobe.tile_sort_schedule(1 << 18)) == 11


@pytest.fixture(scope="module")
def jax_tile_sort():
    """``tile_sort`` of the JAX package's ``experiments/micro_pallas.py``
    with its ``pallas_call`` run in interpret mode."""
    original = pl.pallas_call
    pl.pallas_call = functools.partial(original, interpret=True)
    try:
        spec = importlib.util.spec_from_file_location(
            "_tpu_probe_micro_pallas_schedule",
            os.path.join(ROOT, "experiments", "micro_pallas.py"),
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        yield mod.tile_sort
    finally:
        pl.pallas_call = original


@pytest.mark.parametrize("log2_t", range(7, 16))
def test_tile_sort_schedule_replayed_sorts(jax_tile_sort, log2_t):
    """Every step of the schedule, one ``one_stage_plain`` each, on two
    tiles of seeded keys with many ties: ``np.lexsort`` order and the TPU
    probe's result."""
    T = 1 << log2_t
    rows = T // 128
    rng = np.random.default_rng(log2_t)
    k = rng.integers(0, 2**32, (2 * rows, 128), dtype=np.uint64).astype(
        np.uint32)
    k[rows:] &= 7  # the second tile: ties, the payload decides
    v = rng.integers(-2**31, 2**31, (2 * rows, 128), dtype=np.int64).astype(
        np.int32)
    tk, tv = torch.from_numpy(k.view(np.int32)), torch.from_numpy(v)
    for launch in tprobe.tile_sort_schedule(T):
        for size, d in launch.steps:
            tk, tv = tprobe.one_stage_plain(tk, tv, rows, d, size // 2)
    gk, gv = tk.numpy().view(np.uint32), tv.numpy()
    for tile in range(2):
        kt = k[tile * rows:(tile + 1) * rows].reshape(-1)
        vt = v[tile * rows:(tile + 1) * rows].reshape(-1)
        order = np.lexsort([vt, kt])
        np.testing.assert_array_equal(
            gk[tile * rows:(tile + 1) * rows].reshape(-1), kt[order])
        np.testing.assert_array_equal(
            gv[tile * rows:(tile + 1) * rows].reshape(-1), vt[order])
    wk, wv = jax_tile_sort(jnp.asarray(k), jnp.asarray(v), rows)
    np.testing.assert_array_equal(gk, np.asarray(wk))
    np.testing.assert_array_equal(gv, np.asarray(wv))


# ------------------------------------- K1's plain version against lax.sort


def _edge_keys(kind, w, n, seed):
    rng = np.random.default_rng(seed)
    keys = np.full((w, n), 0x01020304, dtype=np.uint32)
    if kind == "random":
        keys = rng.integers(0, 2**32, (w, n), dtype=np.uint64).astype(
            np.uint32)
    elif kind == "two":  # two distinct keys
        keys[:, rng.random(n) < 0.5] = 0xFFFFFFFF
    elif kind == "all_but_one":  # one digit holds every key but one
        keys[:, n // 2] = 0
    elif kind == "ties":  # duplicate keys: the input order decides
        keys = rng.integers(0, 3, (w, n)).astype(np.uint32)
    else:
        assert kind == "equal"
    return keys


@pytest.mark.parametrize(
    "kind,w,n",
    [("equal", 5, TILE), ("two", 5, TILE), ("all_but_one", 5, TILE),
     ("random", 1, 1), ("ties", 8, 1),
     ("random", 5, TILE - 1), ("random", 5, TILE), ("random", 5, TILE + 1),
     ("ties", 8, TILE - 1), ("ties", 8, TILE), ("ties", 8, TILE + 1),
     ("ties", 1, TILE + 1), ("two", 9, TILE + 1), ("random", 9, TILE - 1),
     ("all_but_one", 1, TILE), ("equal", 8, TILE + 1)],
)
def test_radix_plain_equals_lax_sort(kind, w, n):
    """``lax.sort`` with the row number as a payload word: stable, so
    its payload is the one permutation the port must give."""
    keys = _edge_keys(kind, w, n, w * n)
    out = jax.lax.sort(
        tuple(jnp.asarray(keys[i]) for i in range(w))
        + (jnp.arange(n, dtype=jnp.int32),),
        num_keys=w, is_stable=True,
    )
    sk, perm = radix_sort_words_plain(torch.from_numpy(keys.view(np.int32)))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(out[-1]))
    np.testing.assert_array_equal(
        sk.numpy().view(np.uint32), np.stack([np.asarray(o) for o in out[:-1]])
    )
