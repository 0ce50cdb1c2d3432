"""The check that decides ``correct``: each sampled answer of the window
against the plain reference (``reference/lanczos_expm.py``), by the
numbers of its answer kind, each held to its limit from the cell's file.

The program returns its answer scaled by e^-shift with its own shift, so
its scale is compared after a multiply by e^(shift - reference shift).
A ``topk`` answer's direction and its scale are separate numbers: in
float32 the device eigensolve's error in the top Ritz value (up to ~6e-4
on lambda_max ~ 89 at bn1M) scales the whole answer by e^error, which
the TF32 control's rounding of T matches within 3x there, while on a
mesh the control's direction stays close.  Each cell's file holds
limits on the numbers that separate the program from its control there
(PERF.md, limits); only those are compared.

- ``topk`` (a SummaryResult: top values, their nodes, the norm):
  ``topk_err``, on values divided by their own answer's norm (the
  direction), the widest gap, over the k ranks, between a returned value
  and the reference's value of the same rank or the reference's value at
  the returned node (a wrong node shows as the second), over the
  reference's largest value; nodes out of range or repeated, or a norm
  that is not positive, read as inf.  ``norm_err``, the relative gap of
  the answer's norm on the reference's scale (the scale).
- ``vector`` (a LanczosResult with the whole answer): ``rel_err``,
  ||ans - ref|| / ||ref||, and ``max_err``, max |ans - ref| / max |ref|.
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np


@dataclasses.dataclass
class Reference:
    """The reference's answer (scaled by e^-shift) and what every
    comparison reads of it, worked out once."""

    ans: np.ndarray
    shift: float
    top: np.ndarray     # its largest ``topk`` values, descending
    norm: float
    absmax: float

    @classmethod
    def of(cls, ans: np.ndarray, shift: float, topk: int = 1):
        part = np.partition(ans, ans.shape[0] - topk)[-topk:]
        return cls(ans, float(shift), np.sort(part)[::-1],
                   float(np.linalg.norm(ans)), float(np.abs(ans).max()))


def topk_numbers(result, ref: Reference) -> dict:
    topk = ref.top.shape[0]
    norm = float(result.ans_norm)
    scale = np.exp(float(result.log_scale) - ref.shift)
    norm_err = abs(norm * scale - ref.norm) / ref.norm
    vals = np.asarray(result.top_values, dtype=np.float64)
    nodes = np.asarray(result.top_nodes, dtype=np.int64)
    if (vals.shape != (topk,) or nodes.shape != (topk,) or not norm > 0
            or np.unique(nodes).size != topk or nodes.min() < 0
            or nodes.max() >= ref.ans.shape[0]):
        return {"topk_err": float("inf"), "norm_err": float(norm_err)}
    vals = vals / norm
    top, at_nodes = ref.top / ref.norm, ref.ans[nodes] / ref.norm
    gap = np.maximum(np.abs(vals - top), np.abs(vals - at_nodes))
    return {"topk_err": float(gap.max() / top[0]),
            "norm_err": float(norm_err)}


def vector_numbers(result, ref: Reference) -> dict:
    ans = np.asarray(result.ans, dtype=np.float64)
    if ans.shape != ref.ans.shape:
        return {"rel_err": float("inf"), "max_err": float("inf")}
    diff = ans * np.exp(float(result.log_scale) - ref.shift) - ref.ans
    return {"rel_err": float(np.linalg.norm(diff) / ref.norm),
            "max_err": float(np.abs(diff).max() / ref.absmax)}


def numbers(kind: str, result, ref: Reference) -> dict:
    if kind == "topk":
        return topk_numbers(result, ref)
    if kind == "vector":
        return vector_numbers(result, ref)
    raise ValueError(f"unknown answer kind {kind!r}")


def as_result(kind: str, ans_scaled: np.ndarray, shift: float,
              traffic: dict, dtype=np.float64):
    """A reference answer in the program's place: the fields that
    ``numbers`` reads, cast to ``dtype`` (the control's precision)."""
    ans = np.asarray(ans_scaled, dtype=dtype)
    if kind == "topk":
        topk = int(traffic["kwargs"]["topk"])
        nodes = np.argsort(-ans, kind="stable")[:topk]
        return types.SimpleNamespace(
            top_values=ans[nodes], top_nodes=nodes,
            ans_norm=float(np.linalg.norm(ans)), log_scale=shift)
    return types.SimpleNamespace(ans=ans, log_scale=shift)


def worst(readings: list) -> dict:
    """The largest reading of each number over a list of readings."""
    out = {}
    for r in readings:
        for key, value in r.items():
            value = float("inf") if np.isnan(value) else value
            out[key] = max(out.get(key, value), value)
    return out


def verdict(worst_numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {number: {value, limit}})."""
    checks = {key: {"value": worst_numbers.get(key), "limit": limit}
              for key, limit in limits.items()}
    ok = all(c["value"] is not None and np.isfinite(c["value"])
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
