"""Execution over a 1-D mesh of devices, PyTorch port.

Port of ``kiss_tpu.parallel.mesh``. The JAX package shards every length-N
array of the pipeline over a ``jax.sharding.Mesh`` and lets GSPMD insert
the collectives; PyTorch has no GSPMD, so here a :class:`Mesh` is an
ordered list of D shards and the distributed programs are written once,
as functions over this process's list of blocks, calling the mesh's
collectives where ``kiss_tpu`` calls ``lax.all_to_all``, ``ppermute``,
``psum``, ``all_gather`` and ``axis_index``:

  - **in-process backend** (``group=None``): this process holds all D
    shards, and a collective is a copy between the blocks' devices
    (peer-to-peer between cards). A device may repeat: four shards on one
    card run every distributed algorithm on that card;
  - **process-group backend** (:mod:`kiss_tpu_torch.parallel.distributed`):
    this process holds its own shards and a collective goes through
    ``torch.distributed`` (gloo on the CPU, NCCL on cards).

What is distributed: the sorts (:mod:`.dsort`, :mod:`.ssort`: every local
sort is kernel K1), the index tables of the build (:mod:`.fm_build`), the
row-sharded index (:mod:`.fm_sharded`) and the query batch of
:func:`sharded_batch_query` (kernel K2 on each shard). The rest of the
pipeline -- key packing, the rank rebuild, the tail refinement -- runs at
full length on the lead device, replicated in each process.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from kiss_tpu_torch.models import fm_index as fm
from kiss_tpu_torch.utils.device import resolve_device


class Mesh:
    """D shards in order. ``devices`` are this process's shards' devices,
    in shard order; with a process group every process holds the same
    number of shards, process r the shards [r * L, (r + 1) * L). ``lead``
    (the first local shard's device) holds what is replicated."""

    def __init__(self, devices, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.group = group
        L = len(self.devices)
        if group is None:
            self.size, first = L, 0
        else:
            self.size = L * dist.get_world_size(group)
            first = L * dist.get_rank(group)
        self.local = list(range(first, first + L))
        self.lead = self.devices[0]

    def _rank_of(self, shard: int) -> int:
        return shard // len(self.local)

    # -- placement ---------------------------------------------------------

    def split(self, x: torch.Tensor, dim: int = -1) -> list:
        """This process's blocks of ``x`` (replicated: every process has
        all of it), cut into D equal blocks along ``dim``, each made
        contiguous on its shard's device."""
        if x.shape[dim] % self.size:
            raise ValueError(f"{x.shape[dim]} rows do not split into "
                             f"{self.size} shards")
        B = x.shape[dim] // self.size
        return [
            x.narrow(dim, s * B, B).to(d, non_blocking=True).contiguous()
            for s, d in zip(self.local, self.devices)
        ]

    def join(self, blocks: list, dim: int = -1) -> torch.Tensor:
        """The blocks of every shard concatenated along ``dim``, on the
        lead device (the inverse of :meth:`split`)."""
        if self.group is None:
            return torch.cat([b.to(self.lead) for b in blocks], dim=dim)
        return torch.cat(list(self.all_gather(blocks).unbind(0)), dim=dim)

    # -- collectives ---------------------------------------------------------

    def all_to_all(self, xs: list) -> list:
        """``lax.all_to_all(x, split_axis=0, concat_axis=0)``: each local
        ``xs[i]`` is [D, ...] and its row j goes to shard j; the result's
        row j on each shard is what shard j sent it."""
        if self.group is None:
            return [
                torch.stack([x[i].to(d, non_blocking=True) for x in xs])
                for i, d in enumerate(self.devices)
            ]
        L, P = len(self.local), self.size // len(self.local)
        send = torch.stack([x.to(self.lead) for x in xs])  # [L, D, ...]
        rest = send.shape[2:]
        # destination-rank major: [P, L_src, L_dst, ...]
        send = send.reshape(L, P, L, *rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)  # [P (source rank), L_src, L_dst, ...]
        dist.all_to_all_single(recv, send, group=self.group)
        recv = recv.permute(2, 0, 1, *range(3, recv.dim()))
        recv = recv.reshape(L, self.size, *rest)
        return [r.to(d) for r, d in zip(recv.unbind(0), self.devices)]

    def ppermute(self, xs: list, perm) -> list:
        """``lax.ppermute``: for each (source, destination) pair of
        ``perm`` the source shard's block goes to the destination; a shard
        that no pair names as destination gets zeros shaped like its own
        block."""
        src_of = {t: s for s, t in perm}
        pos = {s: i for i, s in enumerate(self.local)}
        out = [None] * len(xs)
        ops = []
        for s, t in perm:
            if s in pos and t in pos:
                out[pos[t]] = xs[pos[s]].to(self.devices[pos[t]],
                                            non_blocking=True)
            elif s in pos:
                ops.append(dist.P2POp(dist.isend, xs[pos[s]].contiguous(),
                                      self._rank_of(t), self.group))
            elif t in pos:
                out[pos[t]] = torch.empty_like(xs[pos[t]])
                ops.append(dist.P2POp(dist.irecv, out[pos[t]],
                                      self._rank_of(s), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return [
            o if t in src_of else torch.zeros_like(x)
            for t, x, o in zip(self.local, xs, out)
        ]

    def psum(self, xs: list) -> torch.Tensor:
        """``lax.psum``: the sum of every shard's block, on the lead
        device."""
        total = xs[0].to(self.lead, copy=True)
        for x in xs[1:]:
            total = total + x.to(self.lead)
        if self.group is not None:
            dist.all_reduce(total, group=self.group)
        return total

    def all_gather(self, xs: list) -> torch.Tensor:
        """``lax.all_gather``: every shard's block stacked in shard order,
        [D, ...] on the lead device."""
        mine = torch.stack([x.to(self.lead) for x in xs])
        if self.group is None:
            return mine
        parts = [torch.empty_like(mine)
                 for _ in range(self.size // len(self.local))]
        dist.all_gather(parts, mine.contiguous(), group=self.group)
        return torch.cat(parts)


def make_mesh(n_devices: int | None = None, device="cuda", devices=None):
    """The in-process mesh. ``devices`` names each shard's device and may
    repeat one (four shards on one card). Otherwise ``n_devices`` shards:
    on ``device="cuda"`` the first n distinct visible cards -- fewer
    visible raises, as ``kiss_tpu``'s ``make_mesh`` does --, on
    ``device="cpu"`` n CPU shards."""
    if devices is not None:
        return Mesh([resolve_device(d) for d in devices])
    n = n_devices or 1
    dev = resolve_device(device)
    if dev.type != "cuda":
        return Mesh([dev] * n)
    avail = torch.cuda.device_count()
    if avail < n:
        raise ValueError(
            f"mesh of {n} devices requested but only {avail} CUDA "
            "device(s) visible; pass devices=[...] to place several shards "
            "on one card, or device='cpu' for CPU shards"
        )
    return Mesh([torch.device("cuda", i) for i in range(n)])


def sharded_suffix_sort(mesh: Mesh, text, k):
    """k-ordered SA (int64 on the lead device) with every global sort on
    the mesh (:mod:`kiss_tpu_torch.parallel.dsort`)."""
    from kiss_tpu_torch.parallel import dsort

    return dsort.sharded_k_ordered_suffix_array(mesh, text, k)


def _replica(t, device):
    return type(t)(*(x.to(device, non_blocking=True) for x in t))


def sharded_batch_query(mesh: Mesh, arrays: fm.FMArrays, queries,
                        lookup_len: int = 0, *, blocks: fm.FMBlocks):
    """Backward search with the queries split over the shards (data
    parallel): each shard runs kernel K2 (``fm_backward_search``, its
    plain version on a CPU shard) on its own replica of the index and its
    block table. ``queries`` int8 [Q, m] (numpy or tensor). Returns (beg,
    end, offs) int64 [Q] on the lead device."""
    if isinstance(queries, torch.Tensor):
        queries = queries.cpu().numpy()
    queries = np.ascontiguousarray(queries, dtype=np.int8)
    q, m = queries.shape
    qw = fm._packed_queries(queries, mesh.lead)
    pad = -q % mesh.size
    qw = torch.cat([qw, qw.new_zeros((pad, qw.shape[1]))])
    outs = []
    for qs in mesh.split(qw, dim=0):
        outs.append(torch.stack(fm.get_range_packed_device(
            _replica(arrays, qs.device), qs, m, lookup_len,
            blocks=_replica(blocks, qs.device),
        )))
    beg, end, offs = mesh.join(outs, dim=1)[:, :q]
    return beg, end, offs


def sharded_pipeline_step(mesh: Mesh, text, queries):
    """The flagship pipeline over the mesh: the fully sorted SA with
    every sort on the mesh, the index built from it on the lead device,
    and one batched backward search. Returns (sa, beg, counts)."""
    from kiss_tpu_torch.parallel import dsort

    text = dsort.text_on(mesh, text)
    sa = dsort.sharded_k_ordered_suffix_array(mesh, text, fm.SORT_LEN)
    arrays = fm.build_index_device(text, sa, 4)
    blocks = fm.block_table(arrays, 4)
    beg, end, _ = fm.get_range_device(arrays, queries, 0, blocks=blocks)
    return sa, beg, end - beg
