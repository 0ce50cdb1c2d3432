"""pack_s: host wall of the cell's pack call, the card synchronized."""

UNIT, BETTER, SOURCE = "s", "lower", "host_clock"
LAYER, MOVES = "pack", "setup_s"


def read(run):
    return run.pack_s
