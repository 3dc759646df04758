"""CB401 positive: untyped builtin raises in library code."""


def check_group(group_size):
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    if group_size > 64:
        raise RuntimeError("group too large")
