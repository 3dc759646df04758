"""Model library: the JAX package's ten architectures and cb-paper, on
PyTorch: the dense, MoE, SSM, hybrid, encoder-decoder and VLM families."""
from .model import Model, params_from_numpy  # noqa: F401
from .sharding import axis_rules, constrain, logical_to_sharding  # noqa: F401
