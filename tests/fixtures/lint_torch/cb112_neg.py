"""CB112 negative: the port's own modules (``repro_torch``), torch and numpy."""
import numpy as np
import torch

from repro_torch import errors
from repro_torch.core import CBMatrix

from . import sibling  # noqa: F401  (relative imports are the port's own)


def from_numpy(x):
    return torch.from_numpy(np.asarray(x)), CBMatrix, errors
