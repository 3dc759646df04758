"""CB301 negative: the lane width spelled via the single home."""
from repro_torch.core.streams import LANE, spmm_block_n


def spmm_launch(stream, x, block_n=LANE):
    return stream, x, spmm_block_n(x.shape[1], block_n)
