"""CB112 positive: the port reaching for JAX and the reference package."""
import jax.numpy as jnp
import optax
from repro.core import CBMatrix
from repro import errors

import repro


def to_jax(x):
    return jnp.asarray(x), optax, CBMatrix, errors, repro
