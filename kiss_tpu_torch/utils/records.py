"""Generic tab-separated record IO.

Copy of ``kiss_tpu.utils.records`` for the PyTorch port (standard
library only).

Counterpart of the reference's reflection-based Record/Header framework
(reference: include/biovoltron/file_io/core/{record,header,tuple}.hpp:
structured-binding field reflection feeding generic TSV stream
operators). Python dataclasses give the same field reflection natively,
so the machinery collapses to a few functions: any dataclass whose
fields are str/int/float (or lists thereof) round-trips through
tab-separated lines; header lines (leading '#' or '@') are carried
alongside, mirroring the reference ``Header`` concept.
"""

from __future__ import annotations

import dataclasses
from typing import get_args, get_origin

HEADER_PREFIXES = ("#", "@")


def to_line(record) -> str:
    """Serialize a dataclass instance to one TSV line
    (reference: core/record.hpp operator<<)."""
    parts = []
    for f in dataclasses.fields(record):
        v = getattr(record, f.name)
        if isinstance(v, (list, tuple)):
            parts.append(",".join(str(x) for x in v))
        else:
            parts.append(str(v))
    return "\t".join(parts)


def _convert(value: str, typ):
    origin = get_origin(typ)
    if origin in (list, tuple) or typ in (list, tuple):
        container = origin or typ
        args = get_args(typ)
        item_t = args[0] if args else str
        items = [_convert(x, item_t) for x in value.split(",")] if value else []
        return container(items)
    if typ in (int, float):
        return typ(value)
    return value


def from_line(cls, line: str):
    """Parse one TSV line into a dataclass instance
    (reference: core/record.hpp operator>>)."""
    import typing

    fields = dataclasses.fields(cls)
    try:
        hints = typing.get_type_hints(cls)  # resolves PEP-563 strings
    except Exception:
        hints = {}
    values = line.rstrip("\n").split("\t")
    if len(values) < len(fields):
        raise ValueError(
            f"expected {len(fields)} fields for {cls.__name__}, "
            f"got {len(values)}"
        )
    return cls(**{
        f.name: _convert(v, hints.get(f.name, str))
        for f, v in zip(fields, values)
    })


def read_records(cls, src) -> tuple[list[str], list]:
    """Read (header_lines, records) from a path or iterable of lines
    (reference: core/header.hpp + istream_view of records)."""
    if isinstance(src, str):
        with open(src) as f:
            lines = f.readlines()
    else:
        lines = list(src)
    header = [
        ln.rstrip("\n") for ln in lines if ln.startswith(HEADER_PREFIXES)
    ]
    records = [
        from_line(cls, ln)
        for ln in lines
        if ln.strip() and not ln.startswith(HEADER_PREFIXES)
    ]
    return header, records


def write_records(path: str, records, header: list[str] = ()) -> None:
    with open(path, "w") as f:
        for h in header:
            f.write(h + "\n")
        for r in records:
            f.write(to_line(r) + "\n")
