"""CB301 positive: the SpMM lane width re-hardcoded as 128."""


def spmm_launch(stream, x, block_n=128):
    return stream, x, block_n


def run(stream, x):
    return spmm_launch(stream, x, block_n=128)
