"""The check that decides ``correct``: the program passes it and the
control fails it at a small size, and a run whose timed path is broken
underneath comes out not correct.  On the CPU the port runs its kernels'
plain versions; the harness's look for a card is skipped.

A fault that rescales the whole answer (``scale_altered``) fails only a
cell that compares a scale number: ``rel_err`` and ``max_err`` in df64.
The float32 top-k cell compares the direction alone (its ``norm_err``
has no limit; see PERF.md), so that fault passes it, and this test says
so until a limit on the float32 scale comes in."""

import importlib

import numpy as np
import pytest

from lanczos_bench.harness import control, correct, graphs
from lanczos_bench.harness.cell import run_cell
from lanczos_bench.tests.helpers import small_cell
import tpu_lanczos_torch as tl
from tpu_lanczos_torch.kernels import spmv_cpg

# the modules, not the functions core/__init__.py exports by their names
lanczos_mod = importlib.import_module("tpu_lanczos_torch.core.lanczos")
lanczos_df_mod = importlib.import_module("tpu_lanczos_torch.core.lanczos_df")

CELLS = ["ba1M.topk20.f32", "ba1M.expm.df64"]
# numbers that see the answer's scale
SCALE_NUMBERS = {"norm_err", "rel_err", "max_err"}


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(workload):
    cell = small_cell(workload)
    t = cell.traffic
    indptr, indices = graphs.generate(cell.config, 2**31 + 3)
    g = tl.CSRGraph(indptr=indptr, indices=indices, n=indptr.shape[0] - 1)
    dg = getattr(tl, t["pack"])(g, device="cpu")
    result = getattr(tl, t["entry"])(g, dg=dg, **t["kwargs"])
    ref = control.reference(t, indptr, indices)
    ok, _ = correct.verdict(correct.numbers(t["answer"], result, ref),
                            cell.limits)
    assert ok
    ok, checks = correct.verdict(
        control.control_numbers(t, indptr, indices, ref), cell.limits)
    assert not ok, checks


def _half_rows(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        for t in (out if isinstance(out, tuple) else (out,)):
            t[0::2] = 0  # every other row of the product
        return out
    return broken


def _altered(fn):
    def broken(*args, **kw):
        r = fn(*args, **kw)
        if hasattr(r, "top_values"):
            r.top_values[0] *= 1.01
        else:
            r.ans[int(np.argmax(np.abs(r.ans)))] *= 1.01
        return r
    return broken


def _rescaled(fn):
    def broken(*args, **kw):
        r = fn(*args, **kw)
        r.log_scale += 1e-2  # every value e^0.01 too large
        return r
    return broken


def _plant(monkeypatch, fault, df):
    if fault == "state_unchanged":
        if df:
            monkeypatch.setattr(lanczos_df_mod, "lanczos_step_df",
                                lambda v, q, *a, **kw: q)
        else:
            monkeypatch.setattr(lanczos_mod, "lanczos_step",
                                lambda v, q, *a, **kw: q)
    elif fault == "half_left_out":
        if df:
            monkeypatch.setattr(lanczos_df_mod, "spmv_cpg_df",
                                _half_rows(lanczos_df_mod.spmv_cpg_df))
        else:
            monkeypatch.setattr(spmv_cpg, "spmv_cpg",
                                _half_rows(spmv_cpg.spmv_cpg))
    else:
        name = "expm_action_df" if df else "expm_action_summary"
        wrap = _rescaled if fault == "scale_altered" else _altered
        monkeypatch.setattr(tl, name, wrap(getattr(tl, name)))


@pytest.mark.parametrize("fault", [None, "state_unchanged", "half_left_out",
                                   "answer_altered", "scale_altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    cell = small_cell(workload, k=20)
    if fault is not None:
        _plant(monkeypatch, fault, df=cell.traffic["precision"] == "df64")
    out = run_cell(cell, 2**31 + 17, 0.0, False, device="cpu")
    assert out["attempted"] == 1
    caught = fault is not None and (
        fault != "scale_altered" or bool(SCALE_NUMBERS & set(cell.limits)))
    assert out["correct"] is (not caught), out["checks"]
    if fault == "scale_altered" and caught:
        scale = {k: out["checks"][k]["value"]
                 for k in SCALE_NUMBERS & set(cell.limits)}
        assert max(scale.values()) > 9e-3, scale
    assert set(out["checks"]) == set(cell.limits)
