"""Device milliseconds a build in the span ``kiss.build.tables``:
``build_index_device`` (the BWT, the occurrence tables, the marks and the
sampled SA) with its upload of the text, between two CUDA events; the
block table and the sort are outside it."""

from kissbench.spans import device_ms_per_op

SOURCE, LAYER, UNIT, MOVES = ("program_span", "library build", "ms",
                              "build_Mbp_s")


def read(s, work):
    return device_ms_per_op(s, "kiss.build.tables")
