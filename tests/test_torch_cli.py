"""The port's CLI (tpu_lanczos_torch.cli.main) on the CPU: the
counterparts of tests/test_aux.py's single-device CLI cases at the same
bars, the same argv through both CLIs, every single-device mode and
format (``--fmt cst`` included), and ``--shards N`` (the port on N CPU
shards) alone, with the estimators and with df64.

Bars: f64 answers within 1e-10 of the oracle (the reference's CLI bar)
and of the JAX CLI's answer on the same argv, with the same -v top-10;
the slab layout within 1e-10 of the classic one (f64); df64 below 1e-12
against the oracle; --topk's fused and host paths give the same nodes.
The estimators (--estrada/--subgraph/--dos) on tests/test_stochastic.py's
ba200 graph in float64 print the dense oracle's values exactly as the
JAX CLI does, and meet that file's bands against them (the seeded
estimates themselves differ: torch's generator is not JAX's); their
refusals print the JAX CLI's messages.  The --shards runs meet the bars
of their single-device twins, and their refusals print the JAX CLI's
messages too.
"""

import numpy as np
import pytest
import torch

from tpu_lanczos.cli.main import main as ref_main
from tpu_lanczos.graphs import generators
from tpu_lanczos_torch.cli.main import main
from tpu_lanczos_torch.eval import oracle
from tpu_lanczos_torch.eval.check import read_ans
from tpu_lanczos_torch.graphs import io as gio

from _torch_cases import to_port_graph


def run(argv, capsys):
    rc = main(list(argv) + ["--device", "cpu"])
    return rc, capsys.readouterr().out


def rel_of(out: str) -> float:
    return float(out.split("relative ")[1].split(")")[0])


def top10(out: str) -> str:
    return out.split("top-10 central nodes: ")[1].split("\n")[0]


def test_cli_generated_graph(capsys):
    rc, out = run(["-n", "500", "-e", "1500", "-k", "20", "--dtype",
                   "float64", "-v"], capsys)
    assert rc == 0
    assert "speedup vs serial" in out and "device vs serial" in out
    assert "top-10 central nodes" in out
    assert rel_of(out) < 1e-10


def test_cli_mtx_and_write_ans(tmp_path, capsys):
    g = to_port_graph(generators.uniform_random(200, 600, seed=1))
    p = str(tmp_path / "g.mtx")
    gio.write_mtx(g, p)
    ap = str(tmp_path / "ans.txt")
    rc, _ = run(["-f", p, "-k", "15", "--dtype", "float64", "--write-ans",
                 ap], capsys)
    assert rc == 0
    ref = oracle.expm_action(g, np.ones(g.n), 15)
    assert oracle.rel_error(read_ans(ap), ref) < 1e-10


def test_cli_pipeline_flag(capsys):
    rc, out = run(["-n", "500", "-e", "1500", "-k", "20", "--dtype",
                   "float64", "--pipeline", "3", "-v"], capsys)
    assert rc == 0
    assert "pipelined x3" in out and "s/query" in out
    assert rel_of(out) < 1e-10


def test_cli_pipeline_flag_rejects_df64():
    assert main(["-n", "300", "-e", "900", "-k", "10", "--dtype", "df64",
                 "--pipeline", "2", "--device", "cpu"]) == 2


def test_cli_topk_fused_and_host(capsys):
    argv = ["-n", "800", "-b", "4", "-k", "20", "--topk", "5", "--no-serial"]
    rc, out_dev = run(argv, capsys)
    assert rc == 0 and "top-5 nodes:" in out_dev
    rc, out_host = run(argv + ["--eig", "host"], capsys)
    assert rc == 0

    def nodes(s):
        return s.split("top-5 nodes: ")[1].split("\n")[0]

    assert nodes(out_dev) == nodes(out_host)
    rc, out_lm = run(argv + ["--low-mem"], capsys)
    assert rc == 0 and nodes(out_lm) == nodes(out_host)


@pytest.mark.parametrize("argv", [
    ["-n", "600", "-b", "4", "-k", "20"],
    ["-n", "500", "-e", "1500", "-k", "20", "--fmt", "hyb"],
    ["-n", "600", "-b", "4", "-k", "20", "--fmt", "cst"],
])
def test_same_argv_through_both_clis(argv, tmp_path, capsys):
    argv = argv + ["--dtype", "float64", "-v", "--no-serial"]
    ap, ap_ref = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    rc, out = run(argv + ["--write-ans", ap], capsys)
    assert rc == 0
    assert ref_main(argv + ["--write-ans", ap_ref]) == 0
    out_ref = capsys.readouterr().out
    assert oracle.rel_error(read_ans(ap), read_ans(ap_ref)) < 1e-10
    assert top10(out) == top10(out_ref)


def test_cli_slab_layout_agrees_with_classic(tmp_path, capsys):
    base = ["-n", "20000", "-b", "4", "-k", "20", "--dtype", "float64",
            "--fmt", "cpg", "--cpg-sub", "256", "--no-serial"]
    answers = {}
    for layout in ("classic", "slab"):
        path = str(tmp_path / f"{layout}.txt")
        rc, _ = run(base + ["--cpg-layout", layout, "--write-ans", path],
                    capsys)
        assert rc == 0
        answers[layout] = read_ans(path)
    assert oracle.rel_error(answers["slab"], answers["classic"]) < 1e-10


def test_cli_df64_slab(capsys):
    rc, out = run(["-n", "2000", "-b", "4", "-k", "20", "--dtype", "df64",
                   "--fmt", "cpg", "--cpg-layout", "slab"], capsys)
    assert rc == 0 and "device pipeline (df64)" in out
    assert rel_of(out) < 1e-12


def test_cli_ks_and_func(tmp_path, capsys):
    ap = str(tmp_path / "ks")
    rc, out = run(["-n", "1000", "-b", "4", "--ks", "5,10,20", "--dtype",
                   "float64", "--write-ans", ap], capsys)
    assert rc == 0 and "rel diff vs k_max" in out
    g = to_port_graph(generators.barabasi_albert(1000, 4, seed=0))
    for k in (5, 10, 20):
        want = oracle.expm_action(g, np.ones(g.n), k)
        assert oracle.rel_error(read_ans(f"{ap}.k{k}"), want) < 1e-10
    rc, out = run(["-n", "1000", "-b", "4", "--ks", "10,20", "--dtype",
                   "df64"], capsys)
    assert rc == 0 and "one k_max=20 decomposition" in out
    rc, out = run(["-n", "1000", "-b", "4", "-k", "20", "--dtype", "float64",
                   "--func", "heat:0.5", "-v"], capsys)
    assert rc == 0 and "exp(-0.5A)" in out
    assert rel_of(out) < 1e-10
    assert main(["-n", "300", "-e", "900", "--func", "cos", "--topk", "3",
                 "--device", "cpu"]) == 2


@pytest.mark.parametrize("fmt", ["best", "auto", "ell", "coo", "hyb", "cpg",
                                 "cst"])
def test_cli_each_format(fmt, capsys):
    rc, out = run(["-n", "600", "-b", "4", "-k", "20", "--dtype", "float64",
                   "--fmt", fmt, "--reorthogonalize"], capsys)
    assert rc == 0
    assert rel_of(out) < 1e-10


def _both(argv, capsys):
    """argv through the JAX CLI and the port's (--device cpu): (rc, out,
    err) of each."""
    rc_ref = ref_main(argv)
    ref = capsys.readouterr()
    rc = main(argv + ["--device", "cpu"])
    port = capsys.readouterr()
    return (rc_ref, ref.out, ref.err), (rc, port.out, port.err)


SHARDS_BASE = ["-b", "3", "-n", "200", "--seed", "1", "-k", "40", "--dtype",
               "float64", "--deflate", "8", "--fmt", "auto"]


@pytest.mark.parametrize("flags", [
    ["--estrada", "32", "--shards", "2"],
    ["--subgraph", "32", "--shards", "2"],
    ["--dos", "32", "--shards", "2"],
    ["--shards", "2"],
    ["--fmt", "cst", "--shards", "2"],
])
def test_cli_shards_through_both_clis(flags, tmp_path, capsys):
    """The same --shards argv through both CLIs: rc 0 and the printed
    numbers within the bars of the matching single-device cases (the
    estimators on ba200 against the dense oracle, whose lines both print
    alike; e^A.x in float64 within 1e-10 of the serial oracle and of the
    JAX CLI's answer, with its top-10); --fmt cst exits 2 in both with the
    reference's stderr.  --fmt auto: the JAX CLI packs CPG for "best" on
    a TPU only."""
    argv = SHARDS_BASE + flags
    if flags[0] == "--shards":
        argv += ["-v", "--write-ans", str(tmp_path / "ans.txt")]
    (rc_ref, out_ref, err_ref), (rc, out, err) = _both(argv, capsys)
    if "cst" in flags:
        assert rc_ref == rc == 2 and err == err_ref
        return
    assert rc_ref == 0 and rc == 0, err
    if flags[0] == "--shards":
        assert "2-shard mesh pipeline (float64)" in out
        assert rel_of(out) < 1e-10 and rel_of(out_ref) < 1e-10
        assert top10(out) == top10(out_ref)
        return
    assert "2-shard mesh (stochastic estimators, ShardedGraph)" in out
    assert _oracle_lines(out) == _oracle_lines(out_ref)
    if flags[0] == "--estrada":
        assert float(out.split("rel err ")[1].split()[0]) < 2e-3
    elif flags[0] == "--subgraph":
        assert float(out.split("rel l2 err ")[1].split(",")[0]) < 0.02
        assert "top-1 match: True" in out
    else:
        for o in (out, out_ref):
            assert abs(float(o.split("mass=")[1].split()[0]) - 1.0) < 1e-3
        lam = [[float(v) for v in o.split("lambda in [")[1].split("]")[0]
                .split(", ")] for o in (out, out_ref)]
        np.testing.assert_allclose(lam[0], lam[1], atol=1e-3)


def test_cli_shards_df64_cpg_and_refusals(capsys):
    """--shards with df64 and with the CPG pack (the port's sharded CPG
    kernel path) against the serial oracle, and every --shards refusal
    with the JAX CLI's stderr."""
    base = ["-n", "600", "-b", "4", "-k", "20", "--shards", "2"]
    rc, out = run(base + ["--dtype", "df64"], capsys)
    assert rc == 0 and "2-shard mesh pipeline (df64)" in out
    assert rel_of(out) < 1e-12
    rc, out = run(base + ["--dtype", "float64", "--fmt", "cpg",
                          "--cpg-sub", "256"], capsys)
    assert rc == 0 and rel_of(out) < 1e-10
    for flags in (["--topk", "5"], ["--pipeline", "2"], ["--ks", "5,10"],
                  ["--func", "heat:0.5"], ["--fmt", "cpg", "--cpg-layout",
                                            "slab"],
                  ["--dtype", "df64", "--cpg-layout", "slab"],
                  ["--estrada", "4", "--fmt", "cst"]):
        (rc_ref, _, err_ref), (rc, _, err) = _both(base + flags, capsys)
        assert rc_ref == rc == 2 and err == err_ref, flags


def test_cli_without_cuda_refuses_to_run_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["-n", "200", "-e", "600"]) != 0
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err
    assert "device pipeline" not in captured.out


def test_cli_fmt_cst_modes_and_topk_refusal(capsys):
    """--fmt cst in the single-device modes against the oracle (f64,
    1e-10), as the JAX CLI runs them; --topk refuses CST in both CLIs
    with the reference's message."""
    base = ["-n", "600", "-b", "4", "-k", "20", "--dtype", "float64",
            "--fmt", "cst"]
    for extra in (["--low-mem"], ["--pipeline", "2"], ["--func", "heat:0.5"]):
        rc, out = run(base + extra, capsys)
        assert rc == 0, extra
        assert rel_of(out) < 1e-10, extra
    rc, out = run(base + ["--ks", "10,20"], capsys)
    assert rc == 0 and "one k_max=20 decomposition" in out
    argv = ["-n", "300", "-e", "900", "--fmt", "cst", "--topk", "5"]
    assert ref_main(argv) == 2
    ref_err = capsys.readouterr().err
    assert main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == ref_err


ESTIMATORS = ["-b", "3", "-n", "200", "--seed", "1", "-k", "40", "--dtype",
              "float64", "--estrada", "32", "--subgraph", "32", "--dos",
              "32", "--deflate", "8"]


def _oracle_lines(out: str) -> list:
    return [ln.split("dense oracle: ")[1].split("   rel err")[0].split(
        ", top-1")[0].split("rel l2 err")[0]
            for ln in out.splitlines() if "dense oracle: " in ln]


def test_cli_estimators_against_the_dense_oracle(tmp_path, capsys):
    """The fast ELL pack (--fmt auto) here; chip_smoke.py runs the same
    argv through the default CPG pack and its kernel on the card."""
    ap = str(tmp_path / "diag.txt")
    rc, out = run(ESTIMATORS + ["--fmt", "auto", "--write-ans", ap], capsys)
    assert rc == 0
    est = float(out.split("Estrada index")[1].split("rel err ")[1].split()[0])
    assert est < 2e-3
    sub = out.split("rel l2 err ")[1]
    assert float(sub.split(",")[0]) < 0.02
    assert "top-1 match: True" in out
    mass = float(out.split("mass=")[1].split()[0])
    assert abs(mass - 1.0) < 1e-3
    assert read_ans(ap).shape == (200,)
    assert np.loadtxt(ap + ".dos").shape == (512, 2)
    assert ref_main(ESTIMATORS + ["--fmt", "auto"]) == 0
    out_ref = capsys.readouterr().out
    want = _oracle_lines(out_ref)
    assert len(want) == 2 and _oracle_lines(out) == want


def test_cli_trace_fa_and_cpg_estimators(capsys):
    rc, out = run(["-b", "3", "-n", "200", "--seed", "1", "-k", "40",
                   "--dtype", "float64", "--estrada", "32", "--func",
                   "heat:1", "--fmt", "auto"], capsys)
    assert rc == 0 and "tr(exp(-1.0A)) ~=" in out
    assert float(out.split("rel err ")[1].split()[0]) < 0.05
    # the default pack (CPG) on a few probes
    rc, out = run(["-b", "3", "-n", "200", "--seed", "1", "-k", "10",
                   "--dtype", "float64", "--estrada", "2", "--subgraph", "2",
                   "--deflate", "4"], capsys)
    assert rc == 0
    assert float(out.split("rel err ")[1].split()[0]) < 0.05


@pytest.mark.parametrize("flags", [
    ["--estrada", "8", "--topk", "5"],
    ["--subgraph", "8", "--low-mem"],
    ["--dos", "8", "--dtype", "df64"],
    ["--estrada", "8", "--reorthogonalize"],
    ["--dos", "8", "--pipeline", "2"],
    ["--subgraph", "8", "--func", "heat:0.5"],
    ["--ks", "10,20", "--estrada", "8"],
])
def test_cli_estimator_refusals_match_reference(flags, capsys):
    argv = ["-n", "300", "-e", "900", "-k", "10"] + flags
    assert ref_main(argv) == 2
    ref_err = capsys.readouterr().err
    assert main(argv + ["--device", "cpu"]) == 2
    assert capsys.readouterr().err == ref_err
