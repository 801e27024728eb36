"""Characters given a k-ordered suffix array, in millions a second: the
characters of every sort of the window over the window's time."""


def read(w):
    return w.work / w.seconds / 1e6
