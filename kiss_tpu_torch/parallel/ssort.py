"""Splitter-based distributed sample sort over a device mesh, PyTorch
port.

Port of ``kiss_tpu.parallel.ssort``: one local sort, a splitter
partition, one bucket exchange and one merge, where columnsort
(:mod:`kiss_tpu_torch.parallel.dsort`) takes four local sorts. The steps
are those of the JAX package:

  0. **decorrelating deal**: element j of each block goes to shard
     j mod D (the columnsort deal), so every shard holds a stride-D
     subsample of the whole distribution and per-source bucket loads track
     bucket_total / D even when keys correlate with text position;
  1. local sort of the dealt block (kernel K1);
  2. regular sampling: OVERSAMPLE midpoint-strided rows a shard, gathered
     everywhere and sorted; the splitters are every OVERSAMPLE-th sample
     (PSRS, Shi & Schaeffer 1992);
  3. bucket bounds by the W-word lexicographic rank of each splitter in
     the sorted block (:func:`_lex_less_count`, unsigned);
  4. **capacity-padded uniform all-to-all**: each (source, destination)
     bucket ships in a slot of C = ceil(SLACK * B / D) rows padded with
     all-ones keys;
  5. merge: one local sort of the received SLACK * B rows (the pads sort
     to the tail);
  6. rebalance to exactly B rows a shard: under the balance invariant
     |off_d - d B| <= S (S = SLACK * B - B) a block's rows live only on
     shards d - 1, d and d + 1, so two S-row neighbour slivers complete it.

The count matrix is gathered everywhere before the exchange, and the
bucket bounds, the offsets and the overflow test are read on the host
from it (a D x D download a sort): eager PyTorch needs no static windows.

**Overflow contract**: with adversarial key skew a bucket can exceed C, or
the drift S. Every shard sees the same count matrix on the host, so every
shard decides alike and raises ``SampleSortOverflow`` before the exchange
-- never a silently wrong permutation. (``kiss_tpu`` poisons the output
under ``jit`` and raises at the facade; eager PyTorch knows at once.) Row
counts follow ``kiss_tpu``'s int32 accounting: the facade rejects a padded
N of 2**31 or more.
"""

from __future__ import annotations

import numpy as np
import torch

from kiss_tpu_torch.ops import pack
from kiss_tpu_torch.parallel.dsort import SampleSortOverflow, _deal, _lsort

OVERSAMPLE = 64
SLACK = 1.5


def _lex_less_count(ops: torch.Tensor, splitter_ops: torch.Tensor,
                    t: int) -> torch.Tensor:
    """Number of rows of the (sorted) block ``ops`` (int32 [W, B], uint32
    bits) lexicographically less than splitter ``t`` of ``splitter_ops``
    (int32 [W, D - 1]), comparing unsigned. An int64 scalar tensor."""
    acc = torch.zeros(ops.shape[1], dtype=torch.bool, device=ops.device)
    for x, s in zip(reversed(ops), reversed(splitter_ops)):
        x, sv = pack.as_u32(x), pack.as_u32(s[t])
        acc = (x < sv) | ((x == sv) & acc)
    return acc.sum()


def _sizes(B: int, D: int):
    C = max(-(-int(B * SLACK) // D), 1)
    M = C * D
    S = M - B
    if not 0 < S <= B:
        raise ValueError(f"sample sort sizes B={B}, D={D}: need B >= 2D")
    return C, M, S


def block_sample_sort(mesh, blocks):
    """Globally sort the mesh's blocks (int32 [W, B] each, uint32 bits,
    jointly a total order). Raises :class:`SampleSortOverflow` when a
    bucket exceeds its capacity or the drift bound (see the module
    docstring)."""
    D = mesh.size
    W, B = blocks[0].shape
    if D == 1:
        return [_lsort(b) for b in blocks]
    sorted_ = [_lsort(b) for b in _deal(mesh, blocks)]  # 0, 1
    C, M, S = _sizes(B, D)

    # ---- 2. splitters from a replicated regular sample: midpoints
    # (2j + 1) B / 2s cover the whole block, its top rows included
    s = min(OVERSAMPLE, B)
    idx = (2 * torch.arange(s, dtype=torch.int64) + 1) * B // (2 * s)
    samples = mesh.all_gather([x[:, idx.to(x.device)] for x in sorted_])
    ssorted = _lsort(samples.permute(1, 0, 2).reshape(W, D * s))
    splitters = ssorted[:, s * torch.arange(1, D, device=ssorted.device)]

    # ---- 3. bucket sizes in each sorted block, gathered everywhere
    cvecs = []
    for x in sorted_:
        spl = splitters.to(x.device)
        b = torch.stack([_lex_less_count(x, spl, t) for t in range(D - 1)])
        b = torch.cat([b.new_zeros(1), b, b.new_full((1,), B)])
        cvecs.append(b[1:] - b[:-1])
    cmat = mesh.all_gather(cvecs).cpu().numpy()  # row e: shard e's sends
    m = cmat.sum(axis=0)  # rows landing on each shard
    offx = np.concatenate([[0], np.cumsum(m)])  # global start of each run
    drift = offx[:D] - np.arange(D) * B
    if (cmat > C).any() or (np.abs(drift) > S).any():
        raise SampleSortOverflow(SampleSortOverflow.__doc__)

    # ---- 4, 5. capacity-padded exchange, then the merge
    sends = []
    for i, x in zip(mesh.local, sorted_):
        bounds = np.concatenate([[0], np.cumsum(cmat[i])])
        buf = torch.full((D, W, C), -1, dtype=x.dtype, device=x.device)
        for d in range(D):
            buf[d, :, : cmat[i, d]] = x[:, bounds[d] : bounds[d + 1]]
        sends.append(buf)
    del sorted_
    merged = [_lsort(r.permute(1, 0, 2).reshape(W, M))
              for r in mesh.all_to_all(sends)]
    del sends

    # ---- 6. rebalance: shard i's run holds global rows [offx[i],
    # offx[i + 1]); its block is rows [iB, (i + 1) B)
    tails, heads = [], []
    for i, x in zip(mesh.local, merged):
        t_send = int(np.clip(offx[i + 1] - (i + 1) * B, 0, S))  # to i + 1
        tail = torch.full((W, S), -1, dtype=x.dtype, device=x.device)
        tail[:, :t_send] = x[:, m[i] - t_send : m[i]]
        tails.append(tail)
        heads.append(x[:, :S])
    from_prev = mesh.ppermute(tails, [(e, e + 1) for e in range(D - 1)])
    from_next = mesh.ppermute(heads, [(e, e - 1) for e in range(1, D)])
    outs = []
    for i, x, pt, nh in zip(mesh.local, merged, from_prev, from_next):
        out = torch.full((W, B), -1, dtype=x.dtype, device=x.device)
        t_prev = int(np.clip(offx[i] - i * B, 0, S))
        out[:, :t_prev] = pt[:, :t_prev]
        lo, hi = max(offx[i], i * B), min(offx[i + 1], (i + 1) * B)
        out[:, lo - i * B : hi - i * B] = x[:, lo - offx[i] : hi - offx[i]]
        h_next = int(np.clip((i + 1) * B - offx[i + 1], 0, S))
        q = offx[i + 1] - i * B  # the slot of the next run's first row
        out[:, q : q + h_next] = nh[:, :h_next]
        outs.append(out)
    return outs
