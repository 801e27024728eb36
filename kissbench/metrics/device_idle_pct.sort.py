"""Share of the traced window in which the card ran nothing, in the sort
cells: host work between and inside the sorts."""

from kissbench.readers import idle_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "device", "%", "sort_Mbp_s"


def read(s, work):
    return idle_pct(s)
