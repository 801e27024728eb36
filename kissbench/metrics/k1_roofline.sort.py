"""K1 ``radix_sort_words`` (``csrc/radix_sort.cu``) in the sort cells: the
least time of the keys the program handed K1 inside ``kiss.sort`` (its
counters ``k1_keys`` and ``k1_key_words``, added at each launch) over
K1's device time, in percent. It reads K1's efficiency on the keys it was
given: a change that sorts fewer keys shows in ``k1_device_ms.sort``,
not here."""

from kissbench.spans import k1_roofline

SOURCE, LAYER, UNIT, MOVES = "program_counter", "kernels", "%", "sort_Mbp_s"


def read(s, work):
    return k1_roofline(s, "kiss.sort")
