"""Answer checking and persistence (numpy only).

A copy of ``tpu_lanczos/eval/check.py``, the reference's verification
layer:
- ``check_ans(a, b)``   — pipeline-vs-pipeline diff metrics
                          (parallel-final/lib/check_ans.cu:11-34)
- ``write_ans``/``read_ans`` — persist answer vectors per (matrix, k)
  (parallel-final/lib/write_ans.h:9-16, writeup Table 5)
- ``convergence_study`` — the k-sweep harness (serial/tests/numerical_test.sh)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class DiffReport:
    """Same metrics the reference prints (check_ans.cu:11-34)."""

    max_abs_diff: float
    max_abs_diff_index: int
    max_rel_diff: float
    total_diff_norm: float
    rel_diff_norm: float

    def __str__(self) -> str:
        return (
            f"max |diff| {self.max_abs_diff:.3e} @ {self.max_abs_diff_index}; "
            f"max rel diff {self.max_rel_diff:.3e}; "
            f"norm of diff {self.total_diff_norm:.3e} "
            f"(relative {self.rel_diff_norm:.3e})"
        )


def check_ans(a: np.ndarray, b: np.ndarray) -> DiffReport:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    diff = np.abs(a - b)
    idx = int(np.argmax(diff))
    denom = np.where(np.abs(b) > 0, np.abs(b), 1.0)
    b_norm = float(np.linalg.norm(b))
    return DiffReport(
        max_abs_diff=float(diff[idx]),
        max_abs_diff_index=idx,
        max_rel_diff=float((diff / denom).max()),
        total_diff_norm=float(np.linalg.norm(diff)),
        rel_diff_norm=float(np.linalg.norm(diff) / b_norm) if b_norm else float("inf"),
    )


def write_ans(ans: np.ndarray, path: str) -> None:
    """20-significant-digit text dump (reference prints answers at 20
    digits, serial/lib/lanczos.cc:175-181; files data/<name>/ans<k>.txt)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savetxt(path, np.asarray(ans, dtype=np.float64), fmt="%.20e")


def read_ans(path: str) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float64)


def convergence_study(run_fn, ks, ref_k: int | None = None):
    """Run ``run_fn(k) -> ans`` over a k grid; report successive relative
    differences (the writeup Table 5 metric: norm(ans_k - ans_k')/norm)."""
    ks = sorted(ks)
    if ref_k is not None and ref_k not in ks:
        raise ValueError(f"ref_k={ref_k} must be one of ks={ks}")
    answers = {k: np.asarray(run_fn(k), dtype=np.float64) for k in ks}
    out = {}
    for k_prev, k in zip(ks[:-1], ks[1:]):
        d = np.linalg.norm(answers[k] - answers[k_prev])
        out[(k_prev, k)] = float(d / np.linalg.norm(answers[k]))
    if ref_k is not None:
        ref = answers[ref_k]
        for k in ks:
            out[(k, "ref")] = float(
                np.linalg.norm(answers[k] - ref) / np.linalg.norm(ref)
            )
    return out
