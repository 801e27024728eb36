"""K6 ``occ_tables`` (``csrc/occ_tables.cu``) in the build cells: the least
time of the occurrence tables the program had K6 write inside
``kiss.build`` (its counters ``occ_words``, the lf_tab rows written, and
``occ_sups``, the occ1 rows written, added at each launch: 40 bytes a row
of lf_tab, its word read and its 16 bytes of occ2 and 20 of lf_tab
written, and 32 bytes a row of occ1) over ``occ_tables.cu``'s device time,
in percent. None where K6 counted nothing or did not run (a program
without K6)."""

from kissbench import bounds
from kissbench.readers import roofline_pct
from kissbench.spans import summary

SOURCE, LAYER, UNIT, MOVES = "program_counter", "kernels", "%", "build_Mbp_s"


def read(s, work):
    counts = summary().get("kiss.build", {}).get("counts", {})
    words = counts.get("occ_words", 0)
    if words <= 0:
        return None
    return roofline_pct(
        bounds.bound_ms(40 * words + 32 * counts.get("occ_sups", 0), 0)[0],
        s, "occ_tables.cu")
