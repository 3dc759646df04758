"""CB block-sparse weights as a model feature: pruning and the linear layer."""
from .linear import (  # noqa: F401
    CBLinearSpec,
    CBSparseLinear,
    cb_linear_apply,
    cb_linear_init,
    cb_spec_random,
    cb_tiles_init,
    dense_equivalent,
    from_numpy,
    gather_tiles,
    spec_block_mask,
    spec_from_mask,
)
from .prune import (  # noqa: F401
    block_magnitude_prune,
    block_sparsity_pattern,
    refreeze_due,
    refreeze_spec,
    refreeze_training_step,
)
