from .decode import build_decode_fn, greedy_decode  # noqa: F401
from .engine import Request, ServingEngine  # noqa: F401
