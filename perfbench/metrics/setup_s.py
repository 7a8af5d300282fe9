"""setup_s: seconds from the start of the benchmark's process to the first
timed request (imports, the CUDA context, the kernel library, the weights,
the warm-up at the cell's shapes).  On a checkout's first run it holds
nvcc's build of the kernel library too; the line's ``setup_parts`` gives
that build apart (``build_s``)."""


def read(run):
    return run.setup_s
