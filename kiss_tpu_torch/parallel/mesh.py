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

What is distributed: every length-N array of the pipeline. Each shard
holds its block of it, in one layout shared by the sorts and the build
(:func:`block_rows`: shard s holds the global rows [s B, (s + 1) B), rows
N .. D B - 1 are pads), as GSPMD gives ``kiss_tpu``: the text, the key
words, ranks and SA of the suffix sort (:mod:`.sharded_plan`, every sort
a mesh sort of :mod:`.dsort` / :mod:`.ssort` whose local sorts are kernel
K1), the index tables of the build (:mod:`.fm_build`) and the
row-sharded index (:mod:`.fm_sharded`); the query batch of
:func:`sharded_batch_query` is split over the shards (kernel K2 on each).
The helpers below move the parts of a global array a shard needs beside
its own block (:meth:`Mesh.shift`, :meth:`Mesh.window`,
:meth:`Mesh.prev_last`) with the collectives.
"""

from __future__ import annotations

import math

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

    # -- blocks of a global array (the layout of block_rows) ----------------

    def scatter_host(self, x, B: int) -> list:
        """This process's blocks of the 1-D array ``x`` (numpy, or a
        tensor): shard s's block is x[s B : (s + 1) B], zero past the end
        of ``x``, copied from ``x`` straight to the shard's device."""
        out = []
        for s, d in zip(self.local, self.devices):
            part = x[s * B : (s + 1) * B]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            blk = torch.zeros(B, dtype=part.dtype, device=d)
            blk[: part.shape[0]].copy_(part, non_blocking=True)
            out.append(blk)
        return out

    def take(self, blocks: list, starts, length: int) -> list:
        """Each local shard s's ``x[starts[s] : starts[s] + length]`` of the
        global array x whose blocks (last dimension B) these are, zero
        outside [0, D B). ``starts`` names every shard's start, as each
        shard's sends depend on the others'. Each piece is one
        :meth:`ppermute` from the shard holding it; where every shard asks
        the same rows of its source, the source cuts them before sending.
        """
        B = blocks[0].shape[-1]
        rest = tuple(blocks[0].shape[:-1])
        pieces = [[] for _ in blocks]
        n_pieces = max((st % B + length - 1) // B + 1 for st in starts)
        for j in range(n_pieces if length > 0 else 0):
            spans = []  # (source shard, first row, end row) of each target
            for st in starts:
                q = st // B + j
                spans.append((q, max(st - q * B, 0),
                              min(st + length - q * B, B)))
            live = {(a, b) for q, a, b in spans if 0 <= q < self.size
                    and a < b}
            cut = live.pop() if len(live) == 1 else None
            sent = blocks if cut is None else [
                x[..., cut[0] : cut[1]] for x in blocks]
            got = self.ppermute(sent, [
                (q, t) for t, (q, a, b) in enumerate(spans)
                if 0 <= q < self.size and a < b
            ])
            for i, t in enumerate(self.local):
                q, a, b = spans[t]
                if a >= b:
                    continue
                if not 0 <= q < self.size:
                    pieces[i].append(blocks[i].new_zeros(rest + (b - a,)))
                else:
                    pieces[i].append(got[i] if cut else got[i][..., a:b])
        return [torch.cat(p, dim=-1) if p else x.new_zeros(rest + (0,))
                for p, x in zip(pieces, blocks)]

    def shift(self, blocks: list, off: int, n: int) -> list:
        """The blocks of ``x[p + off]`` (the block form of
        ``ops/suffix_sort.py:_rank_shift``): shard s gets x[s B + off :
        (s + 1) B + off], zero where p + off >= n. Two :meth:`ppermute`s,
        from shards s + off // B and s + off // B + 1, for any off >= 0."""
        B = blocks[0].shape[-1]
        out = self.take(blocks, [s * B + off for s in range(self.size)], B)
        for s, x in zip(self.local, out):
            x[..., max(min(n - off - s * B, B), 0):] = 0
        return out

    def window(self, blocks: list, h: int) -> list:
        """Each shard's block followed by the next ``h`` elements of the
        global array (zero past its end): [..., B + h]. Any h >= 0: past B
        the halo takes several shards' blocks."""
        if h == 0:
            return list(blocks)
        B = blocks[0].shape[-1]
        halo = self.take(blocks, [(s + 1) * B for s in range(self.size)], h)
        return [torch.cat([x, y], dim=-1) for x, y in zip(blocks, halo)]

    def prev_last(self, blocks: list) -> list:
        """The last element (last column) of the previous shard's block,
        [..., 1]; zero on shard 0."""
        B = blocks[0].shape[-1]
        return self.take(blocks, [s * B - 1 for s in range(self.size)], 1)

    def exclusive_scan(self, values: list, op: str = "sum") -> list:
        """Each local shard's exclusive scan over the shards of a value
        (one small tensor a local shard, any shape): the sum of the values
        of the shards before it, or with ``op="max"`` their largest (0 on
        shard 0). Each result on its shard's device."""
        allv = self.all_gather(values)  # [D, ...]
        if op == "sum":
            scan = torch.cumsum(allv, dim=0) - allv
        else:
            scan = torch.cat([torch.zeros_like(allv[:1]),
                              torch.cummax(allv, dim=0).values[:-1]])
        return [scan[s].to(v.device) for s, v in zip(self.local, values)]

    def to_host(self, blocks: list, dim: int = -1) -> np.ndarray:
        """Every shard's block concatenated along ``dim``, as host numpy;
        each block goes to the host on its own (under a process group,
        broadcast from the process that holds it, one block at a time
        through the lead device)."""
        if self.group is None:
            return np.concatenate([b.cpu().numpy() for b in blocks], axis=dim)
        pos = {s: i for i, s in enumerate(self.local)}
        parts = []
        for s in range(self.size):
            buf = (blocks[pos[s]].to(self.lead, copy=True).contiguous()
                   if s in pos else torch.empty_like(blocks[0],
                                                     device=self.lead))
            dist.broadcast(buf, self._rank_of(s), group=self.group)
            parts.append(buf.cpu().numpy())
        return np.concatenate(parts, axis=dim)

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


def block_rows(n_rows: int, d: int) -> int:
    """The block size B of the mesh pipeline for ``n_rows`` rows (N = n +
    1 suffixes) over d shards: ceil((n_rows + 1) / d), and at least
    columnsort's 2 (d - 1)**2, rounded up to lcm(256, 2 d). One B serves
    columnsort (B % 2d == 0), the sample sort's deal, and the build's
    256-row tables; the + 1 leaves the index's last partial block row a
    place (occ2 has N // 16 + 1 rows) and at least one pad row."""
    align = math.lcm(256, 2 * d)
    b = max(-(-(n_rows + 1) // d), 2 * (d - 1) ** 2)
    return -(-b // align) * align


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
    """k-ordered SA (int64 on the lead device): the blocked pipeline of
    :mod:`kiss_tpu_torch.parallel.sharded_plan` on the mesh, its SA
    blocks joined on the lead device."""
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
    """The flagship pipeline over the mesh: the fully sorted SA from the
    blocked pipeline on the mesh, the index built from it on the lead
    device, and one batched backward search. Returns (sa, beg, counts)."""
    from kiss_tpu_torch.parallel import dsort

    text = dsort.text_on(mesh, text)
    sa = dsort.sharded_k_ordered_suffix_array(mesh, text, fm.SORT_LEN)
    arrays = fm.build_index_device(text, sa, 4)
    blocks = fm.block_table(arrays, 4)
    beg, end, _ = fm.get_range_device(arrays, queries, 0, blocks=blocks)
    return sa, beg, end - beg
