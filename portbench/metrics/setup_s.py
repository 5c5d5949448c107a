"""setup_s (s, host clock): from the process's start to the first timed
unit: the kernel build or the load of the built library, the weights and
inputs made from the seed, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
