"""The port's stored-Q checkpoint (tpu_lanczos_torch/core/checkpoint.py::
lanczos_checkpointed) against uninterrupted Lanczos and against the JAX
package's, on the CPU.

Bars and why:
- a run resumed from a snapshot written at j=14 (the counterpart of
  tests/test_aux.py::test_checkpoint_resume_bit_identical, with its spy
  on ``lanczos_range``) equals an uninterrupted ``lanczos`` bit for bit
  (alpha, beta, Q, x_norm), plain and reorthogonalized: the chunks run
  the same steps on the same carry, and the host copy is exact;
- a snapshot of another graph of the same n_pad, of another start vector
  or k, or a corrupt file starts a fresh run, equal bit for bit to
  ``lanczos``; the dtype and ``reorthogonalize`` change the fingerprint;
- ``chunk < 1`` raises, as the reference's does;
- each package reads the ``.npz`` the other wrote, field for field, and
  the same run has the same fingerprint in both (on a CPG pack, whose
  SpMV, and so the structure probe, is bit-identical), so the port
  resumes the reference's snapshot.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_lanczos.core import checkpoint as ref_ck
from tpu_lanczos.graphs import generators
from tpu_lanczos.kernels import cpg as ref_cpg
from tpu_lanczos_torch.core import checkpoint
from tpu_lanczos_torch.core.lanczos import lanczos, lanczos_init, lanczos_range
from tpu_lanczos_torch.kernels.formats import pack

from _torch_cases import port_pack, to_port_graph

K, CHUNK = 24, 7


def _auto_pack(seed):
    g = to_port_graph(generators.uniform_random(400, 1200, seed=seed))
    return pack(g, device="cpu")


def _ones(dg, n=None):
    x = torch.zeros(dg.n_pad, dtype=torch.float64)
    x[: dg.n if n is None else n] = 1.0
    return x


@pytest.fixture(scope="module")
def cpg_pair():
    g = generators.uniform_random(400, 1600, seed=4)
    ref_pack = ref_cpg.pack_cpg(g)
    return ref_pack, port_pack(ref_pack)


def _assert_same_state(got, want):
    for name in ("alpha", "beta", "q_basis", "x_norm"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _spy_ranges(monkeypatch):
    """Record the j0 of every chunk the checkpointed run executes."""
    seen = []
    real = checkpoint.lanczos_range

    def spy(dg, carry, j0, j1, **kw):
        seen.append(j0)
        return real(dg, carry, j0, j1, **kw)

    monkeypatch.setattr(checkpoint, "lanczos_range", spy)
    return seen


@pytest.mark.parametrize("kind,reorth", [("auto", False), ("cpg", True)])
def test_checkpoint_resume_bit_identical(kind, reorth, cpg_pair, tmp_path,
                                         monkeypatch):
    dg = _auto_pack(5) if kind == "auto" else cpg_pair[1]
    x = _ones(dg) if kind == "auto" else cpg_pair[1].realmask.double()
    p = str(tmp_path / "ck.npz")
    want = lanczos(dg, x, K, reorthogonalize=reorth)

    got = checkpoint.lanczos_checkpointed(dg, x, K, checkpoint_path=p,
                                          chunk=CHUNK,
                                          reorthogonalize=reorth)
    assert checkpoint.LanczosCheckpoint.load(p).j_done == K
    _assert_same_state(got, want)

    # a genuine snapshot at j=14, then a resume from it
    carry, x_norm = lanczos_init(dg, x, K)
    carry = lanczos_range(dg, carry, 0, 14, reorthogonalize=reorth)
    checkpoint.LanczosCheckpoint(
        j_done=14, k=K, x_norm=float(x_norm),
        fingerprint=checkpoint.run_fingerprint(dg, np.float64, K, reorth,
                                               "auto", x=x.numpy()),
        **dict(zip(checkpoint.LanczosCheckpoint._FIELDS,
                   (c.numpy() for c in carry))),
    ).save(p)
    seen = _spy_ranges(monkeypatch)
    resumed = checkpoint.lanczos_checkpointed(dg, x, K, checkpoint_path=p,
                                              chunk=CHUNK,
                                              reorthogonalize=reorth)
    assert seen == [14, 21], f"resume ran chunks from {seen}, not 14"
    _assert_same_state(resumed, want)


@pytest.mark.parametrize("change", ["graph", "x", "k", "corrupt"])
def test_checkpoint_rejects_mismatched_run(change, tmp_path, monkeypatch):
    p = tmp_path / "ck.npz"
    dg_a, dg_b = _auto_pack(5), _auto_pack(6)
    assert dg_a.n_pad == dg_b.n_pad
    x, k, dg = _ones(dg_a), K, dg_a
    checkpoint.lanczos_checkpointed(dg_a, x, K, checkpoint_path=str(p),
                                    chunk=5)
    if change == "graph":
        dg = dg_b
    elif change == "x":
        x = x.clone()
        x[0] = 2.0
    elif change == "k":
        k = K - 4
    else:
        p.write_bytes(b"not a checkpoint")
    seen = _spy_ranges(monkeypatch)
    got = checkpoint.lanczos_checkpointed(dg, x, k, checkpoint_path=str(p),
                                          chunk=5)
    assert seen[0] == 0, "a foreign snapshot was resumed"
    _assert_same_state(got, lanczos(dg, x, k))

    fp = checkpoint.run_fingerprint
    assert fp(dg_b, np.float64, k, False, "auto") != \
        fp(dg_b, np.float32, k, False, "auto")
    assert fp(dg_b, np.float64, k, False, "auto") != \
        fp(dg_b, np.float64, k, True, "auto")


@pytest.mark.parametrize("chunk", [0, -3])
def test_checkpoint_rejects_nonpositive_chunk(chunk, tmp_path):
    dg = _auto_pack(1)
    with pytest.raises(ValueError, match="chunk"):
        checkpoint.lanczos_checkpointed(
            dg, _ones(dg), 8, checkpoint_path=str(tmp_path / "c.npz"),
            chunk=chunk)


def test_snapshots_read_and_resume_across_packages(cpg_pair, tmp_path,
                                                   monkeypatch):
    ref_pack, port = cpg_pair
    k = 12
    x = port.realmask.double()
    p_ref, p_port = str(tmp_path / "ref.npz"), str(tmp_path / "port.npz")
    ref_ck.lanczos_checkpointed(ref_pack, jnp.asarray(x.numpy()), k,
                                checkpoint_path=p_ref, chunk=5)
    checkpoint.lanczos_checkpointed(port, x, k, checkpoint_path=p_port,
                                    chunk=5)
    fields = checkpoint.LanczosCheckpoint._FIELDS
    for path in (p_ref, p_port):
        mine = checkpoint.LanczosCheckpoint.load(path)
        theirs = ref_ck.LanczosCheckpoint.load(path)
        for f in ("j_done", "k", "x_norm", "fingerprint"):
            assert getattr(mine, f) == getattr(theirs, f), f
        for f in fields:
            np.testing.assert_array_equal(getattr(mine, f),
                                          getattr(theirs, f))
    a, b = (checkpoint.LanczosCheckpoint.load(p) for p in (p_port, p_ref))
    assert a.fingerprint == b.fingerprint == ref_ck.run_fingerprint(
        ref_pack, np.float64, k, False, "auto", x=x.numpy())
    np.testing.assert_allclose(a.alpha, b.alpha, rtol=1e-10)
    # the reference's finished snapshot is resumed, not recomputed
    seen = _spy_ranges(monkeypatch)
    got = checkpoint.lanczos_checkpointed(port, x, k, checkpoint_path=p_ref,
                                          chunk=5)
    assert seen == []
    np.testing.assert_array_equal(got.alpha.numpy(), b.alpha)
    np.testing.assert_array_equal(got.q_basis.numpy(), b.q_basis)
