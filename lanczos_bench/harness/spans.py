"""The program's own spans of the cell's served query, for the per-layer
metrics that read them (``source`` ``program_span``).

Once a traced run, after the readers that time the card from outside,
``recorded(run)`` runs the cell's own query ``QUERIES[precision]`` times
on the run's pack inside the program's ``obs.recording()``, with no
profiler active, and keeps each query's span tree as plain records:
``{"name", "kind", "wall_ms", "device_ms", "children"}``.  ``median``
sums a field over the stages that match in each query and takes the
median over the queries.  A program without ``obs`` (a checkout older
than its spans) gives None, and every reader with it.
"""

from __future__ import annotations

import importlib

import numpy as np

from lanczos_bench.harness.cell import PROGRAM

QUERIES = {"float32": 20, "df64": 10}
ATTR = "_program_spans"


def record(span) -> dict:
    """A program span as a plain record, its children with it."""
    return {"name": span.name, "kind": span.kind, "wall_ms": span.wall_ms,
            "device_ms": span.device_ms,
            "children": [record(c) for c in span.children]}


def _record_queries(run):
    try:
        obs = importlib.import_module(f"{PROGRAM}.obs")
    except ModuleNotFoundError:
        return None
    count = QUERIES[run.traffic["precision"]]
    with obs.recording() as rec:
        for _ in range(count):
            run.query()
        roots = rec.take()
    return [record(r) for r in roots if r.name == "query"]


def recorded(run):
    """The recorded query trees of ``run`` (made on the first call, kept
    on the run), or None where the program has no spans."""
    if not hasattr(run, ATTR):
        setattr(run, ATTR, _record_queries(run))
    return getattr(run, ATTR)


def total(tree: dict, field: str, match) -> float | None:
    """``field`` summed over the spans under ``tree`` that ``match``
    (outermost only: a match's own children are not visited); None if a
    matching span has no value."""
    out = 0.0
    for c in tree["children"]:
        if match(c):
            if c[field] is None:
                return None
            out += c[field]
        else:
            sub = total(c, field, match)
            if sub is None:
                return None
            out += sub
    return out


def median(queries, field: str, match) -> float | None:
    """The median over ``queries`` of ``total``; None without queries,
    where a query holds no match, or where a match has no value."""
    if not queries:
        return None
    values = []
    for q in queries:
        if not any(match(s) for s in _walk(q)):
            return None
        v = total(q, field, match)
        if v is None:
            return None
        values.append(v)
    return float(np.median(values))


def _walk(tree: dict):
    for c in tree["children"]:
        yield c
        yield from _walk(c)


def named(*names):
    return lambda s: s["name"] in names


def of_kind(kind: str):
    return lambda s: s["kind"] == kind
