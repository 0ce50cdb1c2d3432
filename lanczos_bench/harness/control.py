"""The reference's answer, and the control: the reference put in the
program's place in the precision just below the configuration's (the
traffic file's ``control``: TF32 for float32 with TF32 off, float32 for
f64-grade df64), read by the same numbers as the program's answers."""

from __future__ import annotations

import numpy as np

from lanczos_bench.harness import correct
from lanczos_bench.reference import lanczos_expm


def reference(traffic: dict, indptr, indices) -> correct.Reference:
    """The float64 reference's answer to the traffic's query."""
    ans, shift, _, _ = lanczos_expm.expm_lanczos(
        indptr, indices, int(traffic["kwargs"]["k"]), "float64")
    return correct.Reference.of(ans, shift,
                                int(traffic["kwargs"].get("topk", 1)))


def control_numbers(traffic: dict, indptr, indices,
                    ref: correct.Reference) -> dict:
    precision = traffic["control"]
    ans, c_shift, _, _ = lanczos_expm.expm_lanczos(
        indptr, indices, int(traffic["kwargs"]["k"]), precision)
    dtype = np.float64 if precision == "float64" else np.float32
    result = correct.as_result(traffic["answer"], ans, c_shift, traffic,
                               dtype)
    return correct.numbers(traffic["answer"], result, ref)
