"""The allocator's peak over the window (``torch.cuda.max_memory_allocated``
after a reset at the window's start), in bytes a character of the text:
what sets the genome that fits in core."""


def read(w):
    return w.peak_bytes / w.n
