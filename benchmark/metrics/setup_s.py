"""setup_s: seconds from the process's start to the first timed call
(imports, the CUDA context, inputs made from the seed, the codec and its
tables, the kernels' build or load, and the warm-up passes)."""


def read(run):
    return run.setup_s
