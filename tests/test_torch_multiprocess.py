"""Two processes, two CPU shards each, form one 4-shard mesh over
``torch.distributed`` (gloo): the process-group backend of every
collective (all-to-all, ppermute, psum, all-gather, broadcast) must give
what one process gives alone -- the mesh SA by columnsort, bitonic and
sample sort, the blocked pipeline's SA blocks (each process holding only
its own two), the sharded build's tables, and the row-sharded query
stats. The counterpart of ``tests/test_multiprocess.py``."""

import multiprocessing
import socket
import traceback

import numpy as np
import torch

from tests import oracle

WORLD = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, port: int, results) -> None:
    try:
        torch.set_num_threads(1)
        from kiss_tpu_torch.models import fm_index as fm
        from kiss_tpu_torch.ops.suffix_sort import k_ordered_suffix_array
        from kiss_tpu_torch.parallel import (
            distributed,
            dsort,
            fm_build,
            sharded_plan,
        )
        from kiss_tpu_torch.parallel.mesh import block_rows
        from kiss_tpu_torch.parallel.fm_sharded import ShardedFMQuery

        distributed.initialize(f"tcp://localhost:{port}", world_size=WORLD,
                               rank=rank, backend="gloo")
        mesh = distributed.global_mesh(["cpu", "cpu"])
        info = distributed.process_info(mesh)
        assert info == {"process_index": rank, "process_count": WORLD,
                        "local_devices": 2, "global_devices": 4}, info
        text = oracle.repeat_heavy_dna(4096, unit=37, seed=7)
        for k, algorithm in ((64, "auto"), (-1, "bitonic"),
                             (64, "sample")):
            got = dsort.sharded_k_ordered_suffix_array(
                mesh, text, k, algorithm=algorithm)
            want = k_ordered_suffix_array(text, k, device="cpu")
            np.testing.assert_array_equal(got.numpy(), want)
        # the blocked pipeline: this process holds shards 2r and 2r + 1,
        # one block of B rows each, and the SA gathers on the host
        want = k_ordered_suffix_array(text, -1, device="cpu")
        B = block_rows(len(text) + 1, 4)
        blocks = sharded_plan.sharded_sa_blocks(mesh, text, -1)
        assert mesh.local == [2 * rank, 2 * rank + 1]
        assert [tuple(b.shape) for b in blocks] == [(B,), (B,)]
        full = np.arange(4 * B)  # pad rows hold their row ids
        full[: len(want)] = want
        for s, b in zip(mesh.local, blocks):
            np.testing.assert_array_equal(b.numpy(),
                                          full[s * B : (s + 1) * B])
        np.testing.assert_array_equal(
            mesh.to_host(blocks)[: len(want)], want)
        tables = fm_build.build_index_blocks(mesh, text, blocks, 4)
        assert all(len(t) == 2 for t in tables[:8])
        host = fm_build.tables_to_host(
            mesh, tables, fm_build.sharded_lookup(mesh, tables, 3), 4)
        single = fm.FMIndex(sa_intv=4, lookup_len=3, device="cpu").build(text)
        for name in fm.FMArrays._fields:
            assert torch.equal(getattr(host, name),
                               getattr(single.arrays, name)), name
        sa = k_ordered_suffix_array(text, -1, as_numpy=False, device="cpu")
        got = fm_build.trim_canonical(
            fm_build.build_index_sharded(mesh, text, sa, 4), len(text) + 1, 4)
        want = fm.build_index_device(torch.from_numpy(text), sa, 4)
        for name in fm.FMArrays._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), name
        fmi = fm.FMIndex(sa_intv=4, device="cpu").build(text)
        rng = np.random.default_rng(1)
        queries = np.stack([text[p : p + 12]
                            for p in rng.integers(0, len(text) - 12, 30)])
        assert (ShardedFMQuery(mesh, fmi).batch_query_stats(queries)
                == fmi.batch_query_stats(queries))
        torch.distributed.destroy_process_group()
        results.put((rank, "OK"))
    except BaseException:  # reported to the parent, which fails the test
        results.put((rank, traceback.format_exc()))


def test_two_process_mesh():
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_worker, args=(rank, port, results))
             for rank in range(WORLD)]
    for p in procs:
        p.start()
    try:
        got = dict(results.get(timeout=240) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert got == {rank: "OK" for rank in range(WORLD)}, got
    assert all(p.exitcode == 0 for p in procs)
