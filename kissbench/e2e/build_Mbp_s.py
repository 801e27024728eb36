"""Characters indexed, in millions a second: the characters of every
index build of the window over the window's time."""


def read(w):
    return w.work / w.seconds / 1e6
