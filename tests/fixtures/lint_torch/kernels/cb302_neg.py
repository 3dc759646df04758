"""CB302 negative: alignment arithmetic through the named constants."""
from repro_torch.core.streams import LANE, SUBLANE


def pack_rows(width, lane):
    slots = lane // SUBLANE
    if width % LANE:
        width = width + (LANE - width % LANE)
    return slots, width
