"""Device milliseconds a sort of everything that is not a hand-written
kernel of the program: the plain-PyTorch glue of ``ops/suffix_sort.py``
(key packing, rank rebuilds, tail refinement), copies and sets."""

from kissbench.readers import per_op_ms

SOURCE, LAYER, UNIT, MOVES = ("device_trace", "library sort", "ms",
                              "sort_Mbp_s")


def read(s, work):
    return per_op_ms(s.seconds_of(hand=False), s)
