"""setup_s: from the first import of the program to the end of the
warm-up queries (kernel library, pack with its copy to the card, every
shape of the window warmed).  A run that builds the library with nvcc
counts the build here, and also reports it apart (``build`` in the
result line, ``span build`` on standard error)."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(run):
    return run.setup_s
