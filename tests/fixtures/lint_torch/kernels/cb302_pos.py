"""CB302 positive: alignment arithmetic with magic literals in kernels/."""


def pack_rows(width, lane):
    slots = lane // 8
    if width % 128:
        width = width + (128 - width % 128)
    return slots, width
