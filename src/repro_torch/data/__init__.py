from . import matrices, synthetic  # noqa: F401
