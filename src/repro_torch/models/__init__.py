"""Model library: the dense and VLM families of the JAX package's ten
architectures, on PyTorch (the others are not ported yet)."""
from .model import Model, params_from_numpy  # noqa: F401
from .sharding import axis_rules, constrain, logical_to_sharding  # noqa: F401
