"""The frozen generators give the port's graphs, array for array."""

import numpy as np
import pytest

from lanczos_bench.graphs import barabasi_albert, stencil_2d
from tpu_lanczos_torch.graphs import generators, native


def _same(indptr, indices, g):
    assert indptr.dtype == g.indptr.dtype and indices.dtype == g.indices.dtype
    assert np.array_equal(indptr, g.indptr)
    assert np.array_equal(indices, g.indices)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 11, 2**40 + 3])
@pytest.mark.parametrize("n,m", [(1500, 10), (400, 3)])
def test_barabasi_albert_equals_the_ports(n, m, seed):
    indptr, indices = barabasi_albert.barabasi_albert(n, m, seed)
    _same(indptr, indices, native.barabasi_albert(n, m, seed))
    assert indices.shape[0] == 2 * (m * (m + 1) // 2 + (n - m - 1) * m)


@pytest.mark.parametrize("side", [1, 2, 3, 17, 64])
def test_stencil_equals_the_ports(side):
    indptr, indices = stencil_2d.stencil_2d(side)
    _same(indptr, indices, generators.stencil_2d(side))


def test_generate_reads_the_config():
    cfg = {"generator": "stencil_2d", "side": 5}
    a = stencil_2d.generate(cfg, 1)
    b = stencil_2d.generate(cfg, 99)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    ba = {"generator": "barabasi_albert", "n": 200, "m": 4}
    assert not np.array_equal(barabasi_albert.generate(ba, 1)[1],
                              barabasi_albert.generate(ba, 2)[1])
    with pytest.raises(ValueError):
        barabasi_albert.barabasi_albert(10, 20, 1)
