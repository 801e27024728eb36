"""K4 ``fm_bfs_stats`` (``csrc/fm_bfs.cu``): the least time of the traced
batches' range BFS (``bounds.k4_bound`` over the nodes, entries and
segments the oracle counts) over K4's device time, in percent."""

from kissbench.readers import roofline_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "kernels", "%", "query_Mpat_s"


def read(s, work):
    return roofline_pct(work.get("bfs_bound_ms"), s, "fm_bfs.cu")
