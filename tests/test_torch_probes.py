"""The seven hardware probes of ``kiss_tpu_torch.experiments`` against the
TPU probes they port (``experiments/micro_pallas.py``,
``experiments/micro_copy.py``): the same seeded numpy inputs go through
the Pallas function, run on the CPU in interpret mode, and through the
port's plain PyTorch version (what a CPU tensor runs). All values are
integers: tolerance 0 everywhere.

Nothing under ``experiments/`` changes for this: the scripts are loaded
with ``importlib`` while ``pl.pallas_call`` is wrapped to pass
``interpret=True``, and the wrapper is taken off again afterwards.
``run_heavy`` is a closure inside the TPU script's ``main``, so its 64
steps are restated here in numpy ``uint32``."""

import functools
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kiss_tpu_torch.experiments import micro_copy as tcopy
from kiss_tpu_torch.experiments import micro_kernels as tprobe

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 128
SHAPES = [(32, 8), (64, 16)]  # (R, rows): 4 tiles each


@pytest.fixture(scope="module")
def jax_probes():
    """(micro_pallas, micro_copy) of the JAX package's experiments, with
    every ``pallas_call`` they make run in interpret mode."""
    original = pl.pallas_call
    pl.pallas_call = functools.partial(original, interpret=True)
    mods = []
    try:
        for name in ("micro_pallas", "micro_copy"):
            spec = importlib.util.spec_from_file_location(
                f"_tpu_probe_{name}",
                os.path.join(ROOT, "experiments", f"{name}.py"),
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            mods.append(mod)
        yield tuple(mods)
    finally:
        pl.pallas_call = original


def _keys(R, seed, high=2**32):
    """uint32 [R, 128] from a seed, the wrap-around values included."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, high, (R, LANES), dtype=np.uint64).astype(np.uint32)
    if high == 2**32:
        k[0, :4] = [0xFFFFFFFF, 0, 0x7FFFFFFF, 0x80000000]
    return k


def _payload(R, seed):
    rng = np.random.default_rng(seed + 1000)
    return rng.integers(-2**31, 2**31, (R, LANES), dtype=np.int64).astype(
        np.int32
    )


def _t(x):
    """numpy uint32/int32 -> the port's int32 tensor of the same bits."""
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("R,rows", SHAPES)
def test_stream_copy_equals_pallas(jax_probes, R, rows):
    jp, _ = jax_probes
    x = _keys(R, R)
    want = np.asarray(jp.stream_copy(jnp.asarray(x), rows))
    got = tprobe.stream_copy(_t(x), rows)
    assert got.dtype == torch.int32 and got.shape == (R, LANES)
    np.testing.assert_array_equal(_u(got), want)
    np.testing.assert_array_equal(want, x + np.uint32(1))


@pytest.mark.parametrize(
    "R,rows,d,stage_d",
    [(32, 8, 1, 1), (32, 8, 2, 8), (32, 8, 128, 128), (32, 8, 512, 512),
     (64, 16, 4, 1024), (64, 16, 1024, 1024), (64, 16, 64, 64),
     (32, 8, 16, 4)],  # the last: a direction bit below d, as it comes
)
@pytest.mark.parametrize("high", [2**32, 4], ids=["wide", "ties"])
def test_one_stage_equals_pallas(jax_probes, R, rows, d, stage_d, high):
    """``high = 4`` makes most keys tie, so the signed payload decides."""
    jp, _ = jax_probes
    k, v = _keys(R, d + stage_d, high), _payload(R, d)
    wk, wv = jp.one_stage(jnp.asarray(k), jnp.asarray(v), rows, d, stage_d)
    gk, gv = tprobe.one_stage(_t(k), _t(v), rows, d, stage_d)
    np.testing.assert_array_equal(_u(gk), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("R,rows", SHAPES)
@pytest.mark.parametrize("high", [2**32, 4], ids=["wide", "ties"])
def test_tile_sort_equals_pallas_and_lexsort(jax_probes, R, rows, high):
    jp, _ = jax_probes
    k, v = _keys(R, 7 * rows, high), _payload(R, rows)
    wk, wv = jp.tile_sort(jnp.asarray(k), jnp.asarray(v), rows)
    gk, gv = tprobe.tile_sort(_t(k), _t(v), rows)
    np.testing.assert_array_equal(_u(gk), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    T = rows * LANES
    kt, vt = k.reshape(-1, T), v.reshape(-1, T)
    for tile in range(kt.shape[0]):
        order = np.lexsort([vt[tile], kt[tile]])  # by key, then payload
        np.testing.assert_array_equal(_u(gk).reshape(-1, T)[tile],
                                      kt[tile][order])
        np.testing.assert_array_equal(gv.numpy().reshape(-1, T)[tile],
                                      vt[tile][order])


@pytest.mark.parametrize("R,rows", SHAPES)
def test_kernel_gather_equals_pallas(jax_probes, R, rows):
    jp, _ = jax_probes
    rng = np.random.default_rng(R)
    table = rng.integers(0, 2**32, 1024, dtype=np.uint64).astype(np.uint32)
    idx = rng.integers(0, 1024, (R, LANES)).astype(np.int32)
    idx[0, :2] = [0, 1023]
    want = np.asarray(jp.kernel_gather(jnp.asarray(table), jnp.asarray(idx),
                                       rows))
    got = tprobe.kernel_gather(_t(table), torch.from_numpy(idx), rows)
    assert got.dtype == torch.int32 and got.shape == (R, LANES)
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("R,rows", SHAPES)
def test_copy_grid_equals_pallas(jax_probes, R, rows):
    _, jc = jax_probes
    x = _keys(R, 3 * R)
    xt = _t(x)
    got = tcopy.copy_grid(xt, rows)
    assert got.data_ptr() != xt.data_ptr()  # a copy, not a view
    for semantics in (None, "parallel", "arbitrary"):  # a hint: same values
        want = np.asarray(jc.copy_grid(jnp.asarray(x), rows, semantics))
        np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("R,rows", SHAPES)
def test_copy_2d_equals_pallas(jax_probes, R, rows):
    _, jc = jax_probes
    x = _keys(R, 5 * R)
    want = np.asarray(jc.copy_2d(jnp.asarray(x), rows))
    got = tcopy.copy_2d(_t(x), rows)
    assert got.shape == want.shape == (R // rows, rows * LANES)
    np.testing.assert_array_equal(_u(got), want)


@pytest.mark.parametrize("R,rows", SHAPES)
def test_run_heavy_equals_uint32_chain(R, rows):
    x = _keys(R, 11 * R)
    want = x.copy()
    for _ in range(64):  # the body of ``heavy``, experiments/micro_copy.py:97
        want = want * np.uint32(2654435761) + np.uint32(12345)
    got = tcopy.run_heavy(_t(x), rows)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u(got), want)


def test_ragged_last_tile_and_whole_tile_rules():
    """The elementwise probes take a last tile that is short; the sorts
    and the 2-D view need whole tiles."""
    x = _t(_keys(40, 1))
    v = _t(_payload(40, 1))
    np.testing.assert_array_equal(
        _u(tprobe.stream_copy(x, 16)), _u(x) + np.uint32(1)
    )
    assert torch.equal(tcopy.copy_grid(x, 16), x)
    assert torch.equal(tcopy.run_heavy(x, 16), tcopy.run_heavy(x, 8))
    for fn in (lambda: tcopy.copy_2d(x, 16),
               lambda: tprobe.one_stage(x, v, 16, 1, 1),
               lambda: tprobe.tile_sort(x, v, 16)):
        with pytest.raises(ValueError, match="whole number"):
            fn()


def test_probe_argument_checks():
    x = _t(_keys(32, 2))
    v = _t(_payload(32, 2))
    with pytest.raises(TypeError, match="int32"):
        tprobe.stream_copy(x.to(torch.int64), 8)
    with pytest.raises(ValueError, match="128"):
        tcopy.copy_grid(x.reshape(64, 64), 8)
    with pytest.raises(ValueError, match="positive"):
        tcopy.run_heavy(x, 0)
    with pytest.raises(ValueError, match="aligned"):
        tprobe.stream_copy(x.reshape(-1)[1:-127].reshape(31, LANES), 1)
    with pytest.raises(ValueError, match="power of two"):
        tprobe.one_stage(x, v, 8, 3, 1)
    with pytest.raises(ValueError, match="power of two"):
        tprobe.one_stage(x, v, 8, 1024, 1)  # 2 * d does not divide T
    with pytest.raises(ValueError, match="stage_d"):
        tprobe.one_stage(x, v, 8, 1, 0)
    with pytest.raises(ValueError, match="power of two"):
        tprobe.tile_sort(_t(_keys(36, 2)), _t(_payload(36, 2)), 12)
    with pytest.raises(ValueError, match="differ"):
        tprobe.tile_sort(x, v[:16], 8)
    with pytest.raises(TypeError, match="int32"):
        tprobe.kernel_gather(x.reshape(-1).to(torch.int64), v, 8)


def test_sort_key_orders_unsigned_key_then_signed_payload():
    k = torch.tensor([-1, 0, 0, 2**31 - 1, -(2**31)], dtype=torch.int32)
    v = torch.tensor([5, -7, 3, 0, 0], dtype=torch.int32)
    order = torch.argsort(tprobe.sort_key(k, v)).tolist()
    # keys as unsigned: 0, 0, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF
    assert order == [1, 2, 3, 4, 0]


@pytest.mark.parametrize(
    "mod,labels",
    [(tprobe, ["stream copy u32 (rows=2048)", "1 bitonic stage d=64k",
               "full tile sort 256K", "torch.sort 1 key per tile 32K",
               "in-kernel gather (32K table, shared memory)",
               "in-kernel gather (64K table, L2)", "GB/s",
               "ms/stage-equivalent"]),
     (tcopy, ["torch x.clone()", "grid copy rows=32768", "2d copy rows=2048",
              "heavy x128ops rows=2048", "Tops/s (u32 mul+add)"])],
    ids=["micro_kernels", "micro_copy"],
)
def test_probe_main_runs_on_cpu(capsys, mod, labels):
    """The probe entry points end to end at one tile, on the CPU (plain
    versions); the first line names the device."""
    assert mod.main(["--device", "cpu", "--elements", "300000"]) == 0
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "cpu" and lines[1].startswith("N=262144 ")
    for label in labels:
        assert label in out, label


def test_probe_main_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the rule is about hosts without")
    for mod in (tprobe, tcopy):
        with pytest.raises(RuntimeError, match="cuda"):
            mod.main([])
    with pytest.raises(ValueError, match="at least"):
        tcopy.main(["--device", "cpu", "--elements", "100"])
