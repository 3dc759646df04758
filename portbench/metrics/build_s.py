"""build_s: the benchmark's clock around the program's host build and its
move to the device (the entry's ``build_s``: from_coo + build_super_streams
+ .to() for the spmv entry), synchronised."""


def read(run):
    return run.build_s
