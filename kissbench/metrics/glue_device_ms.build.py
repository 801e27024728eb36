"""Device milliseconds a build of everything that is not a hand-written
kernel of the program: the glue of the sort (``ops/suffix_sort.py``) and
of the tables (``models/fm_index.py``: ``build_index_device``,
``block_table``), the uploads of the text, copies and sets."""

from kissbench.readers import per_op_ms

SOURCE, LAYER, UNIT, MOVES = ("device_trace", "library build", "ms",
                              "build_Mbp_s")


def read(s, work):
    return per_op_ms(s.seconds_of(hand=False), s)
