"""Multi-process runtime, PyTorch port.

Port of ``kiss_tpu.parallel.distributed``. The reference has no
distributed backend (single-node shared memory, a thread cap its only
knob: reference src/main.cpp:22-26). Here several processes form one mesh
through ``torch.distributed``: each process holds its own shards, and the
mesh's collectives (:class:`kiss_tpu_torch.parallel.mesh.Mesh`) go through
the process group -- gloo on the CPU, NCCL on cards. Every process runs
the same program on the same host inputs (the text, replicated in host
memory); each uploads only its own shards' blocks of it and holds only
its own blocks of every length-N array of the pipeline:

    from kiss_tpu_torch.parallel import distributed, sharded_plan
    distributed.initialize("tcp://localhost:29500", world_size=2, rank=r)
    mesh = distributed.global_mesh(["cpu", "cpu"])  # two shards here
    blocks = sharded_plan.sharded_sa_blocks(mesh, text, k)  # this
    # process's SA blocks; mesh.to_host(blocks) gathers the SA on the host

Nothing tells a program of a cluster: the address, the world size and
the rank come from the caller, or from the environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) when ``init_method`` is None.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kiss_tpu_torch.parallel.mesh import Mesh


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Bring up the default process group (idempotent). ``backend``
    defaults to NCCL when CUDA is available and gloo otherwise."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = world_size
    if rank is not None:
        kwargs["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def global_mesh(devices) -> Mesh:
    """The mesh over every process's shards: ``devices`` are this
    process's (the same count in every process; under NCCL, shards on
    this process's card)."""
    return Mesh(devices, group=dist.group.WORLD)


def process_info(mesh: Mesh | None = None) -> dict:
    """This process's place in the runtime, and with ``mesh`` its shard
    counts."""
    info = {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
    }
    if mesh is not None:
        info["local_devices"] = len(mesh.local)
        info["global_devices"] = mesh.size
    return info
