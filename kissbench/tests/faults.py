"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false: each wraps one of the program's entry points
that a cell's operation calls and breaks what it returns."""

from __future__ import annotations

import torch


def _wrap(module, name, after):
    inner = getattr(module, name)

    def wrapped(*args, **kwargs):
        return after(inner(*args, **kwargs), *args, **kwargs)

    setattr(module, name, wrapped)


def _sort(breaks):
    from kiss_tpu_torch.ops import suffix_sort

    _wrap(suffix_sort, "k_ordered_suffix_array",
          lambda sa, *a, **k: breaks(sa.clone()))


def _swap(sa):  # an answer altered where it is produced
    sa[[5, 6]] = sa[[6, 5]]
    return sa


def _unchanged(sa):  # the rounds return the state they were given
    return torch.arange(sa.shape[0], dtype=sa.dtype, device=sa.device)


def _half(sa):  # half of the rows left as they came
    half = sa.shape[0] // 2
    sa[half:] = sa[half:].sort().values
    return sa


def _index(breaks):
    from kiss_tpu_torch.models import fm_index as fm

    def after(index, *a, **k):
        index.arrays = breaks(index.arrays)
        return index

    _wrap(fm.FMIndex, "build", after)


def _table_entry(arrays):  # one .fmi table entry altered
    occ1 = arrays.occ1.clone()
    occ1[1, 2] += 1
    return arrays._replace(occ1=occ1)


def _lf_rows(arrays):  # the table the backward search reads altered
    lf = arrays.lf_tab.clone()
    lf[lf.shape[0] // 2 :, :4] += 1
    return arrays._replace(lf_tab=lf)


def _tables_unset(arrays):  # the build returns its tables as allocated
    return arrays._replace(bwt_words=torch.zeros_like(arrays.bwt_words),
                           occ1=torch.zeros_like(arrays.occ1),
                           occ2=torch.zeros_like(arrays.occ2))


def _samples_half(arrays):  # half of the sampled SA left out
    samp = arrays.sa_samp.clone()
    samp[samp.shape[0] // 2 :] = 0
    return arrays._replace(sa_samp=samp)


def _stats(breaks):
    from kiss_tpu_torch.models import fm_index as fm

    for name in ("batch_locate_stats_device", "bfs_query_stats"):
        inner = getattr(fm, name)

        def wrapped(idx, beg, end, *a, _inner=inner, **k):
            return breaks(_inner, idx, beg, end, *a, **k)

        setattr(fm, name, wrapped)


def _checksum(inner, idx, beg, end, *a, **k):  # an answer altered
    total, checksum = inner(idx, beg, end, *a, **k)
    return total, checksum + 1


def _batch_half(inner, idx, beg, end, *a, **k):  # half the batch left out
    half = beg.shape[0] // 2
    return inner(idx, beg[:half].contiguous(), end[:half].contiguous(), *a,
                 **k)


def _search_unchanged():  # the backward search returns its start state
    from kiss_tpu_torch.models import fm_index as fm

    def after(out, idx, qwords, *a, **k):
        beg, end, offs = out
        return (torch.zeros_like(beg), torch.full_like(end,
                int(idx.lookup[-1])), torch.zeros_like(offs))

    _wrap(fm, "get_range_packed_device", after)


FAULTS = {
    "sort_swap": lambda: _sort(_swap),
    "sort_unchanged": lambda: _sort(_unchanged),
    "sort_half": lambda: _sort(_half),
    "build_table_entry": lambda: _index(_table_entry),
    "build_lf_rows": lambda: _index(_lf_rows),
    "build_samples_half": lambda: _index(_samples_half),
    "build_unchanged": lambda: _index(_tables_unset),
    "query_checksum": lambda: _stats(_checksum),
    "query_batch_half": lambda: _stats(_batch_half),
    "query_search_unchanged": _search_unchanged,
}


def apply(name: str | None) -> None:
    if name is not None:
        FAULTS[name]()
