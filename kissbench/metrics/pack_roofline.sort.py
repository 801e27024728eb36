"""K5 ``seed_key_words`` (``csrc/seed_pack.cu``) in the sort cells: the
least time of the seed words the program had K5 write inside ``kiss.sort``
(its counters ``seed_keys`` and ``seed_key_words``, added at each
launch: 4 bytes a word written, a text byte a key read) over
``seed_pack.cu``'s device time, in percent. None where K5 counted
nothing or did not run (a program without K5)."""

from kissbench import bounds
from kissbench.readers import roofline_pct
from kissbench.spans import summary

SOURCE, LAYER, UNIT, MOVES = "program_counter", "kernels", "%", "sort_Mbp_s"


def read(s, work):
    counts = summary().get("kiss.sort", {}).get("counts", {})
    words = counts.get("seed_key_words", 0)
    if words <= 0:
        return None
    return roofline_pct(
        bounds.bound_ms(4 * words + counts.get("seed_keys", 0), 0)[0], s,
        "seed_pack.cu")
