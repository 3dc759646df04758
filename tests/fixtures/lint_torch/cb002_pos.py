"""CB002 positive: the analyzer reports parse errors as findings."""
def broken(:
