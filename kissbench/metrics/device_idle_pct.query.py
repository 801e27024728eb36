"""Share of the traced window in which the card ran nothing, in the query
cells: the host's launches and its wait for each batch's two integers."""

from kissbench.readers import idle_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "device", "%", "query_Mpat_s"


def read(s, work):
    return idle_pct(s)
