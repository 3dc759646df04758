"""CB001 negative: a pragma on a line where the named rule really fires."""


def reject(value):
    raise ValueError(value)  # cblint: disable=CB401
