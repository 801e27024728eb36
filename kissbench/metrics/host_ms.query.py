"""Host milliseconds a batch in the library's query wrappers, in the query
cells: the self time of the spans ``kiss.query.search``
(``get_range_packed_device``), ``kiss.query.locate``
(``batch_locate_stats_device``) and ``kiss.query.bfs`` (``_bfs_stats``),
less their child ``kiss.query.wait`` (the download of the two integers):
the checks, allocations and launches the host does while the card waits."""

from kissbench.spans import self_host_ms_per_op

SOURCE, LAYER, UNIT, MOVES = ("program_span", "library queries", "ms",
                              "query_Mpat_s")


def read(s, work):
    return self_host_ms_per_op(
        s, ("kiss.query.search", "kiss.query.locate", "kiss.query.bfs"))
