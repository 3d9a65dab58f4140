"""``setup_s``: from the start of the process that prints the result to the
first timed call: imports, the CUDA context, the kernel library (built
only on a checkout's first run), the inputs made on the card from the seed,
the program's set-up and the warm-up of the cell's own shapes."""


def read(run):
    return run.window.setup_s
