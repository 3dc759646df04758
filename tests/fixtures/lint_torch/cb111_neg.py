"""CB111 negative: the kernel reached through its wrapper and ops."""
from repro_torch.kernels import cb_spmm, ops


def spmm(tiles, bcol, Xb, route, m):
    parts = cb_spmm.super_tile_spmm(tiles, bcol, Xb)
    return parts, ops.spmm_routed(route, tiles, Xb, m)
