from . import matrices  # noqa: F401
