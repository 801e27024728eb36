"""Device milliseconds a sort in the spans ``kiss.sort.round``: the rank
rounds of the sort plan after its seed sort (key packing from the ranks,
K1, the rank rebuild), between two CUDA events each."""

from kissbench.spans import device_ms_per_op

SOURCE, LAYER, UNIT, MOVES = ("program_span", "library sort", "ms",
                              "sort_Mbp_s")


def read(s, work):
    return device_ms_per_op(s, "kiss.sort.round")
