"""The port's mesh sorts (``kiss_tpu_torch.parallel.dsort``) on CPU shards:
columnsort and block-bitonic against the single-device sort
``radix_sort_wide`` (kernel K1's plain version here) across key widths and
adversarial orders, one comparison against ``kiss_tpu``'s mesh sort, and
the sharded suffix array against ``kiss_tpu``'s on its 8-device virtual
mesh. Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.parallel import dsort as jdsort
from kiss_tpu.parallel import mesh as jmesh
from kiss_tpu.parallel.mesh import make_mesh as jmake_mesh
from kiss_tpu_torch.ops.radix_sort import radix_sort_wide
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.parallel import dsort, make_mesh, sharded_suffix_sort
from tests import oracle

torch.set_num_threads(1)


def _keys(order: str, w: int, n: int, seed: int) -> torch.Tensor:
    """int32 [w, n] key words (uint32 bits): ``random`` (few values, many
    ties), ``sorted``, ``reversed``, ``constant``, ``ones`` (all-ones
    words, the pads' value, on a third of the rows)."""
    rng = np.random.default_rng(seed)
    if order == "random":
        keys = rng.integers(0, 4, (w, n), dtype=np.uint64)
        keys[0] = rng.integers(0, 2**32, n, dtype=np.uint64)
    elif order in ("sorted", "reversed"):
        keys = np.tile(np.arange(n, dtype=np.uint64) * 2**20, (w, 1))
        if order == "reversed":
            keys = keys[:, ::-1]
    elif order == "constant":
        keys = np.full((w, n), 0x80000001, dtype=np.uint64)
    else:
        keys = rng.integers(0, 3, (w, n), dtype=np.uint64)
        keys[:, rng.random(n) < 1 / 3] = 0xFFFFFFFF
    keys = np.ascontiguousarray(keys.astype(np.uint32))
    return torch.from_numpy(keys.view(np.int32))


# a size at or under the columnsort floor 2 (D - 1)**2 D (padded up), one
# just over a multiple of 2 D, and one of many blocks
@pytest.mark.parametrize("D,algo", [
    (2, "columnsort"), (3, "columnsort"), (4, "columnsort"),
    (8, "columnsort"), (2, "bitonic"), (4, "bitonic"),
])
@pytest.mark.parametrize("order", ["random", "sorted", "reversed",
                                   "constant", "ones"])
def test_mesh_sort_equals_single_device(D, algo, order):
    mesh = make_mesh(D, device="cpu")
    impl = dsort.make_sharded_sort_impl(mesh, algo)
    for w, n in ((1, 2 * (D - 1) ** 2 * D), (2, 37), (5, 2 * D * 41 + 3),
                 (9, 1000), (10, 777)):
        keys = _keys(order, w, n, seed=D * 100 + w)
        got = impl(keys)
        want = radix_sort_wide(keys)
        assert torch.equal(got[0], want[0]), (w, n)
        assert torch.equal(got[1], want[1]), (w, n)


def test_auto_picks_bitonic_then_columnsort():
    keys = _keys("random", 3, 500, seed=1)
    want = radix_sort_wide(keys)
    for D in (1, 2, 3, 5):
        got = dsort.make_sharded_sort_impl(make_mesh(D, device="cpu"))(keys)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="power-of-2"):
        dsort.make_sharded_sort_impl(make_mesh(3, device="cpu"), "bitonic")


@pytest.mark.parametrize("D,algo", [(4, "columnsort"), (2, "bitonic")])
def test_against_kiss_tpu_mesh_sort(D, algo):
    """kiss_tpu sorts the operands (words..., position) as keys; the port
    appends the row id itself and hands it back as the permutation."""
    n = 3001
    keys = _keys("random", 3, n, seed=7)
    words = keys.numpy().view(np.uint32)
    jimpl = jdsort.make_sharded_sort_impl(jmake_mesh(D), "seq", algo)
    ops = tuple(jnp.asarray(x) for x in words) + (
        jnp.arange(n, dtype=jnp.int32),)
    want = [np.asarray(x) for x in jimpl(ops, num_keys=len(ops))]
    got, perm = dsort.make_sharded_sort_impl(
        make_mesh(D, device="cpu"), algo)(keys)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.stack(want[:3]))
    np.testing.assert_array_equal(perm.numpy(), want[3])


@pytest.fixture(scope="module")
def genome():
    text = oracle.genome_like_dna(6000, ancestral=1 << 10, seed=4)
    text[4000:4600] = np.tile(text[4000:4013], 50)[:600]  # a long repeat
    return text


@pytest.mark.parametrize("k", [64, -1])
@pytest.mark.parametrize("strategy,D", [("wide", 4), ("doubling", 2)])
def test_sharded_sa_equals_kiss_tpu(genome, k, strategy, D):
    """``sharded_k_ordered_suffix_array`` (auto: bitonic at D = 2,
    columnsort at 4) against kiss_tpu's on its virtual mesh and against
    the port's single-device sort."""
    want = np.asarray(jdsort.sharded_k_ordered_suffix_array(
        jmake_mesh(D), jnp.asarray(genome), k, strategy=strategy))
    got = dsort.sharded_k_ordered_suffix_array(
        make_mesh(D, device="cpu"), genome, k, strategy=strategy)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        k_ordered_suffix_array(genome, k, strategy=strategy, device="cpu"))


def test_sharded_suffix_sort_equals_kiss_tpu(genome):
    """The mesh module's entry point against kiss_tpu's, 4 shards."""
    want = np.asarray(jmesh.sharded_suffix_sort(
        jmake_mesh(4), jnp.asarray(genome), 64))
    got = sharded_suffix_sort(make_mesh(4, device="cpu"), genome, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_sa_edge_sizes():
    """Texts of 0, 1 and a few characters, and one whose N is a multiple
    of the columnsort block, on 3 and 4 shards."""
    for n in (0, 1, 2, 7, 24 * 4 - 1):
        text = oracle.random_dna(n, seed=n) if n else np.zeros(0, np.int8)
        for D in (3, 4):
            got = dsort.sharded_k_ordered_suffix_array(
                make_mesh(D, device="cpu"), text, -1)
            np.testing.assert_array_equal(
                got.numpy(), k_ordered_suffix_array(text, -1, device="cpu"))


def test_make_mesh_devices(monkeypatch):
    """Shards on a device list (repeats allowed) or on n CPU shards; CUDA
    asked for and absent raises, and so does a mesh of more distinct cards
    than are visible (one card made visible to the check)."""
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 4 and mesh.local == [0, 1, 2, 3]
    assert make_mesh(3, device="cpu").size == 3
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rules are about hosts without")
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh(2)  # device="cuda" by default
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="only 1 CUDA device"):
        make_mesh(2)
