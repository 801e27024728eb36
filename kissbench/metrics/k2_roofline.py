"""K2 ``fm_backward_search`` (``csrc/fm_search.cu``): the least time of
the traced batches' backward searches (``bounds.k2_bound`` over the LF
steps the oracle counts) over K2's device time, in percent."""

from kissbench.readers import roofline_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "kernels", "%", "query_Mpat_s"


def read(s, work):
    return roofline_pct(work.get("k2_bound_ms"), s, "fm_search.cu")
