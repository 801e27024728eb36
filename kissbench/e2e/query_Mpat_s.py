"""Patterns answered (occurrence total and location checksum), in millions
a second: the patterns of every batch of the window over the window's
time."""


def read(w):
    return w.work / w.seconds / 1e6
