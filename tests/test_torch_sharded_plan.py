"""The mesh pipeline in per-shard blocks (``kiss_tpu_torch.parallel.
sharded_plan`` and ``fm_build.build_index_blocks``) on CPU shards: the
block helpers of ``Mesh`` against slicing the whole array; the blocked SA
bit-identical to the port's single-device sorter over mesh sizes,
algorithms, k, both strategies and edge lengths, and to ``kiss_tpu``'s
sharded SA on its virtual mesh; the blocked build's ``.fmi`` bytes those
of ``kiss_tpu``'s sharded build and the single-device build, its tables
1/D a shard; and the residency rule: no op inside the pipeline makes a
tensor longer than two blocks and the seed's halo. Every comparison is
exact."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kiss_tpu.models import fm_index as jfm
from kiss_tpu.parallel import dsort as jdsort
from kiss_tpu.parallel import fm_build as jfm_build
from kiss_tpu.parallel import mesh as jmesh
from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
from kiss_tpu_torch.parallel import fm_build, make_mesh
from kiss_tpu_torch.parallel.mesh import block_rows
from kiss_tpu_torch.parallel.sharded_plan import sharded_sa_blocks
from kiss_tpu_torch.utils.checks import LongestTensor
from tests import oracle

torch.set_num_threads(1)

SEED_HALO = 63  # the wide seed's 64 characters reach 63 past a block


def _sa(mesh, blocks, n):
    return mesh.to_host(blocks)[: n + 1]


# ---------------------------------------------------------------------------
# block helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 3, 4])
def test_block_helpers_equal_slicing(D):
    """``scatter_host``, ``window``, ``shift``, ``prev_last``, ``take``,
    ``exclusive_scan`` and ``to_host`` against slices of the whole array,
    for 1-D blocks and for [W, B] key blocks."""
    mesh = make_mesh(D, device="cpu")
    n = 700
    B = block_rows(n, D)
    x = np.random.default_rng(D).integers(1, 1000, n)
    full = np.zeros(D * B + 10 * B, np.int64)  # zero past the blocks
    full[:n] = x
    blocks = mesh.scatter_host(x, B)
    assert [tuple(b.shape) for b in blocks] == [(B,)] * D
    np.testing.assert_array_equal(mesh.to_host(blocks), full[: D * B])
    for h in (0, 1, B - 1, B, 3 * B + 5):
        for s, w in enumerate(mesh.window(blocks, h)):
            np.testing.assert_array_equal(w.numpy(),
                                          full[s * B : (s + 1) * B + h])
    for off in (0, 1, B - 1, B, B + 1, 3 * B, n, n + 7):
        for s, w in enumerate(mesh.shift(blocks, off, n)):
            want = full[s * B + off : (s + 1) * B + off].copy()
            want[np.arange(B) + s * B + off >= n] = 0
            np.testing.assert_array_equal(w.numpy(), want)
    words = [torch.stack([b, 2 * b]) for b in blocks]
    for s, p in enumerate(mesh.prev_last(words)):
        want = [0, 0] if s == 0 else [full[s * B - 1], 2 * full[s * B - 1]]
        np.testing.assert_array_equal(p.numpy()[:, 0], want)
    starts = [s * (B // 2) + 3 for s in range(D)]  # not one offset a shard
    for s, t in enumerate(mesh.take(blocks, starts, B // 2)):
        np.testing.assert_array_equal(
            t.numpy(), full[starts[s] : starts[s] + B // 2])
    vals = [torch.tensor([s + 1, 10 - s]) for s in range(D)]
    for s, v in enumerate(mesh.exclusive_scan(vals)):
        np.testing.assert_array_equal(
            v.numpy(), np.array([sum(range(1, s + 1)),
                                 sum(10 - j for j in range(s))]))
    for s, v in enumerate(mesh.exclusive_scan(vals, "max")):
        np.testing.assert_array_equal(
            v.numpy(), [s, 10] if s else [0, 0])


def test_block_rows():
    """One block size for the sorts and the build: at least N + 1 rows
    over the mesh, columnsort's 2 (D - 1)**2, a multiple of 256 and of
    2D."""
    for N in (1, 2, 255, 256, 257, 10_001, 2**20):
        for D in (1, 2, 3, 4, 5, 8, 13):
            B = block_rows(N, D)
            assert B * D >= N + 1 and B >= 2 * (D - 1) ** 2
            assert B % 256 == 0 and B % (2 * D) == 0


# ---------------------------------------------------------------------------
# the blocked SA
# ---------------------------------------------------------------------------


def _texts():
    rng = np.random.default_rng(11)
    unit = rng.integers(0, 4, 700, dtype=np.int8)
    return {
        # N % D != 0 for D = 2, 3, 4
        "n1000": oracle.random_dna(1000, seed=1),
        "pow2m1": oracle.random_dna(2047, seed=2),  # n = 2**11 - 1
        "tiny": oracle.random_dna(5, seed=3),  # every shard but one pads
        # period 700: tie groups live until the rounds shift by 512 * 7 =
        # 3584, several blocks (B = 768 at D = 4)
        "periodic": np.tile(unit, 5)[:3001],
    }


_ALGOS = [(2, "bitonic"), (2, "columnsort"), (2, "sample"), (3, "columnsort"),
          (3, "sample"), (4, "bitonic"), (4, "columnsort"), (4, "sample")]


@pytest.mark.parametrize("k", [16, 64, 65, 256, -1])
@pytest.mark.parametrize("D,algo", _ALGOS)
def test_blocked_sa_equals_single_device(D, algo, k):
    """Every text, both strategies: the SA blocks cut to n + 1 equal the
    single-device SA; pad rows hold their row ids."""
    mesh = make_mesh(D, device="cpu")
    for name, text in _texts().items():
        for strategy in ("wide", "doubling"):
            blocks = sharded_sa_blocks(mesh, text, k, algo, strategy)
            n = len(text)
            B = block_rows(n + 1, D)
            assert [tuple(b.shape) for b in blocks] == [(B,)] * D
            got = mesh.to_host(blocks)
            np.testing.assert_array_equal(
                got[: n + 1],
                k_ordered_suffix_array(text, k, strategy=strategy,
                                       device="cpu"),
                err_msg=f"{name} {strategy}")
            np.testing.assert_array_equal(got[n + 1 :],
                                          np.arange(n + 1, D * B))


@pytest.mark.parametrize("name,D,algo,k,strategy", [
    ("periodic", 4, "columnsort", -1, "wide"),
    ("pow2m1", 2, "bitonic", 65, "doubling"),
    ("n1000", 3, "columnsort", 256, "wide"),
])
def test_blocked_sa_equals_kiss_tpu(name, D, algo, k, strategy):
    """Against kiss_tpu's sharded SA on its virtual mesh (each case jits
    a plan of its own, so only a few)."""
    text = _texts()[name]
    want = np.asarray(jdsort.sharded_k_ordered_suffix_array(
        jmesh.make_mesh(D), jnp.asarray(text), k, algorithm=algo,
        strategy=strategy))
    mesh = make_mesh(D, device="cpu")
    got = _sa(mesh, sharded_sa_blocks(mesh, text, k, algo, strategy),
              len(text))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the blocked build
# ---------------------------------------------------------------------------


def _fmi_bytes(mod, arrays, N, sa_intv, **kw):
    idx = mod.FMIndex(sa_intv=sa_intv, lookup_len=0, arrays=arrays,
                      n_rows=N, **kw)
    buf = io.BytesIO()
    idx.save(buf)
    return buf.getvalue()


@pytest.mark.parametrize("n,D,sa_intv", [(63, 3, 4), (1023, 4, 4),
                                         (2047, 2, 1), (5000, 4, 2)])
def test_blocked_build_fmi_equals_kiss_tpu(n, D, sa_intv):
    """The SA blocks into ``build_index_blocks`` and ``tables_to_host``:
    every canonical array equals the single-device build's, and the
    ``.fmi`` bytes equal kiss_tpu's sharded build's; the lookup table
    built on the row-sharded tables equals the single-device one."""
    text = oracle.repeat_heavy_dna(n, unit=29, seed=n)
    N = n + 1
    mesh = make_mesh(D, device="cpu")
    blocks = sharded_sa_blocks(mesh, text, -1)
    tables = fm_build.build_index_blocks(mesh, text, blocks, sa_intv)
    got = fm_build.tables_to_host(
        mesh, tables, fm_build.sharded_lookup(mesh, tables, 0), sa_intv)
    sa = torch.from_numpy(_sa(mesh, blocks, n))
    single = fm.build_index_device(torch.from_numpy(text), sa, sa_intv)
    for name in fm.FMArrays._fields:
        assert torch.equal(getattr(got, name), getattr(single, name)), name
    jsa = jnp.asarray(sa.numpy().astype(np.uint32))
    want = jfm_build.trim_canonical(
        jfm_build.build_index_sharded(jmesh.make_mesh(D), jnp.asarray(text),
                                      jsa, sa_intv, force_u32=True),
        N, sa_intv)
    assert (_fmi_bytes(fm, got, N, sa_intv, device="cpu")
            == _fmi_bytes(jfm, want, N, sa_intv))
    tf = fm.FMIndex(sa_intv=sa_intv, lookup_len=4, device="cpu").build(
        text, sa=sa)
    assert torch.equal(fm_build.sharded_lookup(mesh, tables, 4),
                       tf.arrays.lookup)


@pytest.mark.parametrize("D", [2, 4])
def test_tables_one_dth_a_shard(D):
    """The counterpart of results_chm13_readiness.md's per-chip / (total
    / D) = 1.000: every shard holds the same bytes of the tables, and D of
    them exceed the canonical tables' bytes by no more than the pad rows
    of the block layout (and of the sampled SA's 256-row blocks)."""
    n = 30_000
    N = n + 1
    text = oracle.random_dna(n, seed=D)
    mesh = make_mesh(D, device="cpu")
    tables = fm_build.build_index_blocks(
        mesh, text, sharded_sa_blocks(mesh, text, 64), 4)
    host = fm_build.tables_to_host(mesh, tables, torch.zeros(2), 4)
    names = ("bwt_words", "occ1", "occ2", "sa_samp", "b_words", "b_occ",
             "lf_tab", "b_tab")

    def nbytes(t):
        return t.numel() * t.element_size()

    per_shard = [sum(nbytes(getattr(tables, k)[i]) for k in names)
                 for i in range(D)]
    assert len(set(per_shard)) == 1
    total = sum(nbytes(getattr(host, k)) for k in names)
    B = block_rows(N, D)
    row_bytes = sum(nbytes(getattr(tables, k)[0]) for k in names
                    if k != "sa_samp") / B
    slack = (D * B - N) * row_bytes + D * 256 * 8 + 64
    assert total <= D * per_shard[0] <= total + slack
    assert D * per_shard[0] / total < 1.1


# ---------------------------------------------------------------------------
# residency
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["columnsort", "bitonic", "sample"])
@pytest.mark.parametrize("k", [65, -1])
def test_no_tensor_as_long_as_the_text(algo, k):
    """Four shards, n = 12,000 (B = 3072): inside the blocked sort and
    build no op makes a tensor longer than 2B + the seed's halo (the
    bitonic merge-split's two blocks are the widest) -- none as long as N.
    The blocked SA is the single-device SA."""
    n = 12_000
    text = oracle.repeat_heavy_dna(n, unit=700, seed=3)
    mesh = make_mesh(4, device="cpu")
    B = block_rows(n + 1, 4)
    with LongestTensor() as rec:
        blocks = sharded_sa_blocks(mesh, text, k, algo)
        fm_build.build_index_blocks(mesh, text, blocks, 4)
    assert B < rec.longest <= 2 * B + SEED_HALO < n + 1
    np.testing.assert_array_equal(_sa(mesh, blocks, n),
                                  k_ordered_suffix_array(text, k,
                                                         device="cpu"))
