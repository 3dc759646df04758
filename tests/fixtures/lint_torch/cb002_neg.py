"""CB002 negative: a well-formed file produces no parse finding."""
VALUE = 42
