"""K2 ``fm_backward_search`` (``csrc/fm_search.cu``) seeded from the seed
table: the least time of the traced batches' seeded backward searches over
K2's device time, in percent. The least time is ``bounds.k2_bound`` over
the seeded LF steps the reference counts (``trace_work``'s ``k2_ops``) and
the seed-table entries the program's counter ``k2_lookup_reads`` (seed
lookups inside ``kiss.query.search``, each the pair ``lookup[key]``,
``lookup[key + 1]``) says were read. None where that counter is absent or
0, so a search that stops seeding loses the metric instead of reading
well."""

from kissbench import bounds
from kissbench.readers import roofline_pct
from kissbench.spans import summary

SOURCE, LAYER, UNIT, MOVES = ("program_counter", "kernels", "%",
                              "query_Mpat_s")


def read(s, work):
    ops = work.get("k2_ops")
    counts = summary().get("kiss.query.search", {}).get("counts", {})
    lookups = counts.get("k2_lookup_reads", 0)
    if not ops or lookups <= 0:
        return None
    entries = 2 * lookups / len(ops)  # an operation is one K2 launch
    bound = sum(bounds.k2_bound(work["k2_sizes"], nq, qwords, lf_steps,
                                entries)[0]
                for nq, qwords, lf_steps in ops)
    return roofline_pct(bound, s, "fm_search.cu")
