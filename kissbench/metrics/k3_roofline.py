"""K3 ``fm_locate_stats`` (``csrc/fm_locate.cu``): the least time of the
traced batches' per-row walks (``bounds.k3_bound`` over the rows and walk
steps the oracle counts) over K3's device time, in percent."""

from kissbench.readers import roofline_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "kernels", "%", "query_Mpat_s"


def read(s, work):
    return roofline_pct(work.get("walk_bound_ms"), s, "fm_locate.cu")
