"""CB111 negative: a kernel wrapper (kernels/cb_*.py) may load the library."""
from repro_torch.kernels import _build


def launch(tiles):
    lib = _build.library()
    with _build.launch_on(tiles.device) as stream:
        return lib.cb_spmm(tiles.data_ptr(), stream)
