"""Device milliseconds a build of K1 ``radix_sort_words``: the kernels of
``kiss_tpu_torch/csrc/radix_sort.cu``."""

from kissbench.readers import per_op_ms

SOURCE, LAYER, UNIT, MOVES = "device_trace", "kernels", "ms", "build_Mbp_s"


def read(s, work):
    return per_op_ms(s.seconds_of(source="radix_sort.cu"), s)
