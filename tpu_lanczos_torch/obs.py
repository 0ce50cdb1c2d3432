"""Spans and counters of the port's served queries.

A span is one stage of a call: its name, its kind, its host start and
end (``time.perf_counter_ns``), its parent, and the id of the query that
every span of one call shares.  Kinds:

- ``host``: the host works with nothing queued on the card;
- ``device``: the host queues card work;
- ``sync``: the host waits on the card.

On CUDA a ``device`` or ``sync`` span also holds two ``torch.cuda.Event``s
recorded at its bounds, on the stream that was current when its root
opened (the served queries run on one stream).  They are read when the
finished trees are taken (``Recording.take``), after the query's last
fetch, so no span ever synchronizes.  A span's self time is its wall
less the part its children cover.

Spans are kept in memory only inside ``recording()``.  Outside it a span
is one check that returns a shared null context: no object, no event.
Whenever a ``torch.profiler`` session is active, recording or not, each
span also opens ``record_function("tpu_lanczos_torch.<name>[<kind>]")``,
so its copy lies in the device trace, on the trace's own clock, over the
kernels it launched.

Counters: the ``query`` span, the root of a served call, keeps the
deltas of the kernels' launch counters (they stay in their modules:
``kernels/spmv_cpg.py``, ``spmv_cst.py``, ``spmv_gpg.py``,
``lanczos_step.py``) by name, and every device-to-host read of the call
goes through ``fetch``, which adds its bytes to ``d2h_bytes`` and one to
``syncs``.

    with obs.recording() as rec:
        expm_action_summary(g, dg=dg, eig_impl="device")
    print(obs.table(rec.take()))
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch

HOST, DEVICE, SYNC = "host", "device", "sync"
PREFIX = "tpu_lanczos_torch."

# the single-device kernels' launch counters, read where they live; a
# module not yet imported has launched nothing
LAUNCH_COUNTERS = (
    ("tpu_lanczos_torch.kernels.spmv_cpg",
     ("launches", "launches_slab", "launches_staged", "launches_comp",
      "launches_comp_slab", "launches_df", "launches_df_slab")),
    ("tpu_lanczos_torch.kernels.spmv_cst", ("launches_cst",)),
    ("tpu_lanczos_torch.kernels.spmv_gpg", ("launches_gpg",)),
    ("tpu_lanczos_torch.kernels.lanczos_step",
     ("launches_step", "launches_step_df")),
)


def _launches() -> dict:
    out = {}
    for module, names in LAUNCH_COUNTERS:
        m = sys.modules.get(module)
        if m is not None:
            for name in names:
                out[name] = getattr(m, name)
    return out


@dataclasses.dataclass(eq=False)
class Span:
    """One recorded stage.  ``device_ms`` is the card time between the
    span's events (None for a ``host`` span and off CUDA), set by
    ``Recording.take``; ``counts`` holds a root's counters."""

    name: str
    kind: str
    query_id: int
    parent: "Span | None" = dataclasses.field(repr=False)
    t0_ns: int
    t1_ns: int = 0
    entry: str | None = None
    stream: "torch.cuda.Stream | None" = dataclasses.field(default=None,
                                                           repr=False)
    children: list = dataclasses.field(default_factory=list, repr=False)
    counts: dict = dataclasses.field(default_factory=dict)
    device_ms: float | None = None
    events: list | None = dataclasses.field(default=None, repr=False)
    launches0: dict | None = dataclasses.field(default=None, repr=False)

    @property
    def wall_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6

    @property
    def self_ms(self) -> float:
        # a call's children run one after another on its thread
        covered = sum(c.t1_ns - c.t0_ns for c in self.children)
        return (self.t1_ns - self.t0_ns - covered) * 1e-6

    def walk(self):
        """This span and every span under it, depth first."""
        yield self
        for c in self.children:
            yield from c.walk()


class Recording:
    """The spans of the calls made inside one ``recording()``."""

    def __init__(self):
        self._stack: list[Span] = []
        self._done: list[Span] = []
        self._next_id = 0

    def take(self) -> list:
        """The finished root spans, oldest first, their card times read;
        the recording forgets them."""
        done, self._done = self._done, []
        for root in done:
            for s in root.walk():
                if s.events is not None:
                    start, end = s.events
                    end.synchronize()
                    s.device_ms = start.elapsed_time(end)
                    s.events = None
        return done

    def _open(self, name, kind, device, entry) -> Span:
        parent = self._stack[-1] if self._stack else None
        if parent is None:
            query_id, self._next_id = self._next_id, self._next_id + 1
            on_cuda = (device is not None
                       and torch.device(device).type == "cuda")
            stream = torch.cuda.current_stream(device) if on_cuda else None
        else:
            query_id, stream = parent.query_id, parent.stream
        s = Span(name=name, kind=kind, query_id=query_id, parent=parent,
                 t0_ns=0, entry=entry, stream=stream)
        if entry is not None:
            s.launches0 = _launches()
        if stream is not None and kind != HOST:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            s.events = [start, None]
        if parent is not None:
            parent.children.append(s)
        self._stack.append(s)
        s.t0_ns = time.perf_counter_ns()
        return s

    def _close(self, s: Span) -> None:
        s.t1_ns = time.perf_counter_ns()
        if s.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(s.stream)
            s.events[1] = end
        if s.launches0 is not None:
            for name, value in _launches().items():
                delta = value - s.launches0.get(name, 0)
                if delta:
                    s.counts[name] = delta
            s.launches0 = None
        self._stack.remove(s)
        if s.parent is None:
            self._done.append(s)


_active: Recording | None = None
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def recording():
    """Keep the spans of the calls made inside the block; yields the
    ``Recording`` whose ``take()`` returns them."""
    global _active
    outer, _active = _active, Recording()
    try:
        yield _active
    finally:
        _active = outer


class _Open:
    """A span while it is open: its profiler copy and its record."""

    __slots__ = ("name", "kind", "device", "entry", "_fn", "_rec", "_span")

    def __init__(self, name, kind, device, entry):
        self.name, self.kind = name, kind
        self.device, self.entry = device, entry

    def __enter__(self):
        self._fn = None
        if torch.autograd._profiler_enabled():
            self._fn = torch.profiler.record_function(
                f"{PREFIX}{self.name}[{self.kind}]")
            self._fn.__enter__()
        self._rec, self._span = _active, None
        if self._rec is not None:
            self._span = self._rec._open(self.name, self.kind, self.device,
                                         self.entry)
        return self._span

    def __exit__(self, *exc):
        if self._span is not None:
            self._rec._close(self._span)
        if self._fn is not None:
            self._fn.__exit__(*exc)
        return False


def span(name: str, kind: str, device=None):
    """The stage ``name`` of kind ``kind``, as a context manager.  A span
    opened with no span around it is a root, and ``device`` says whether
    it and its children time the card; inside a span it is ignored."""
    if _active is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Open(name, kind, device, None)


def query(entry: str, device):
    """The root span ``query`` of one served call of ``entry`` on
    ``device``: a ``sync`` span (the call returns host values) that
    keeps the call's counters."""
    if _active is None and not torch.autograd._profiler_enabled():
        return _NULL
    return _Open("query", SYNC, device, entry)


def fetch(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``: the query paths' one way to read the card.
    Adds the tensor's bytes to ``d2h_bytes`` and one to ``syncs`` on the
    root of the open span."""
    out = t.cpu().numpy()
    rec = _active
    if rec is not None and rec._stack:
        counts = rec._stack[0].counts
        counts["d2h_bytes"] = (counts.get("d2h_bytes", 0)
                               + t.numel() * t.element_size())
        counts["syncs"] = counts.get("syncs", 0) + 1
    return out


def table(roots) -> str:
    """The span table of ``roots``: a row for each stage (a path of span
    names), its kind, calls, host ms, self ms and card ms summed over the
    roots, then the roots' counters summed."""
    rows: dict = {}

    def visit(s: Span, path: tuple):
        path = path + (s.name,)
        row = rows.setdefault(path, [s.kind, 0, 0.0, 0.0, None])
        row[1] += 1
        row[2] += s.wall_ms
        row[3] += s.self_ms
        if s.device_ms is not None:
            row[4] = (row[4] or 0.0) + s.device_ms
        for c in s.children:
            visit(c, path)

    counts: dict = {}
    for root in roots:
        visit(root, ())
        for name, value in root.counts.items():
            counts[name] = counts.get(name, 0) + value
    lines = [f"{'stage':<26} {'kind':<6} {'calls':>5} {'host ms':>10} "
             f"{'self ms':>10} {'card ms':>10}"]
    for path, (kind, calls, host, own, card) in rows.items():
        stage = "  " * (len(path) - 1) + path[-1]
        card_s = "-" if card is None else f"{card:.3f}"
        lines.append(f"{stage:<26} {kind:<6} {calls:>5} {host:>10.3f} "
                     f"{own:>10.3f} {card_s:>10}")
    if counts:
        lines.append("counters: " + " ".join(
            f"{name}={value}" for name, value in counts.items()))
    return "\n".join(lines)
