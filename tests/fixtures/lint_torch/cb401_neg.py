"""CB401 negative: taxonomy raises carrying a stable reason code."""
from repro_torch import errors


def check_group(group_size):
    if group_size < 1:
        raise errors.InvalidArgError(
            f"group_size must be >= 1, got {group_size}"
        )
    raise NotImplementedError("builtin escapes outside the rule are fine")
