"""One reader a metric, found by the metric's name in BENCHMARK.json.

Each module declares what BENCHMARK.json says of the metric (``UNIT``,
``BETTER``, ``SOURCE``; a per-layer metric also ``LAYER`` and ``MOVES``),
which the harness checks, and ``read(run)``: the value, or None where the
run has nothing for it to read.
"""
