"""CB001 positive: suppressions that excuse nothing must themselves fire."""
TOTAL = 1 + 1  # cblint: disable=CB999
COUNT = 2 + 2  # cblint: disable=CB211
