"""Share of the traced window in which the card ran nothing, in the build
cells: the host's part of the build (its two uploads of the text, the
Python between the steps)."""

from kissbench.readers import idle_pct

SOURCE, LAYER, UNIT, MOVES = "device_trace", "device", "%", "build_Mbp_s"


def read(s, work):
    return idle_pct(s)
