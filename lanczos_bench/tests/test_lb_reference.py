"""The plain reference against a dense expm, and its lower precisions."""

import numpy as np
import pytest
import scipy.linalg

from lanczos_bench.graphs import barabasi_albert, stencil_2d
from lanczos_bench.reference import lanczos_expm


def _dense(indptr, indices):
    return lanczos_expm.adjacency(indptr, indices, np.float64).toarray()


@pytest.mark.parametrize("graph", ["ba", "mesh"])
def test_reference_agrees_with_dense_expm(graph):
    if graph == "ba":
        indptr, indices = barabasi_albert.barabasi_albert(60, 3, 5)
    else:
        indptr, indices = stencil_2d.stencil_2d(8)
    a = _dense(indptr, indices)
    x = np.ones(a.shape[0])
    exact = scipy.linalg.expm(a) @ x
    ans, shift, alpha, beta = lanczos_expm.expm_lanczos(indptr, indices, 30)
    assert alpha.shape == (30,) and beta.shape == (29,)
    np.testing.assert_allclose(ans * np.exp(shift), exact, rtol=1e-9)
    # the shift is the largest Ritz value, close to lambda_max
    assert abs(shift - np.linalg.eigvalsh(a)[-1]) < 1e-8


def test_k_clamps_and_a_start_vector_is_taken():
    indptr, indices = stencil_2d.stencil_2d(3)
    ans, _, alpha, _ = lanczos_expm.expm_lanczos(indptr, indices, 50)
    assert alpha.shape == (8,)
    x = np.arange(9.0)
    a = _dense(indptr, indices)
    ans, shift, _, _ = lanczos_expm.expm_lanczos(indptr, indices, 8, x=x)
    np.testing.assert_allclose(ans * np.exp(shift),
                               scipy.linalg.expm(a) @ x, rtol=1e-8)


def test_round_tf32():
    x = np.array([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -3.0 - 2**-12, 0.0,
                  np.float32(np.pi)], dtype=np.float32)
    r = lanczos_expm.round_tf32(x)
    # 10 mantissa bits: 1 + 2^-11 is a tie, away from zero
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10 and r[2] == 1.0 + 2**-10
    assert r[4] == 0.0 and r[3] == -3.0
    bits = r.view(np.uint32)
    assert np.all(bits & np.uint32(0x1FFF) == 0)
    assert abs(float(r[5]) - np.pi) < np.pi * 2**-11


def test_lower_precisions_read_as_such():
    indptr, indices = barabasi_albert.barabasi_albert(2000, 10, 3)
    ref, s64, _, _ = lanczos_expm.expm_lanczos(indptr, indices, 50)
    errs = {}
    for p in ("float32", "tf32"):
        ans, s, _, _ = lanczos_expm.expm_lanczos(indptr, indices, 50, p)
        errs[p] = (np.linalg.norm(ans * np.exp(s - s64) - ref)
                   / np.linalg.norm(ref))
    assert 1e-8 < errs["float32"] < 1e-4
    assert errs["tf32"] > 3 * errs["float32"]
    with pytest.raises(ValueError):
        lanczos_expm.expm_lanczos(indptr, indices, 5, "bfloat16")
