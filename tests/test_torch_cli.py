"""The port's CLI (tpu_lanczos_torch.cli.main) on the CPU: the
counterparts of tests/test_aux.py's single-device CLI cases at the same
bars, the same argv through both CLIs, every single-device mode, and the
flags that are not ported yet.

Bars: f64 answers within 1e-10 of the oracle (the reference's CLI bar)
and of the JAX CLI's answer on the same argv, with the same -v top-10;
the slab layout within 1e-10 of the classic one (f64); df64 below 1e-12
against the oracle; --topk's fused and host paths give the same nodes.
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


@pytest.mark.parametrize("fmt", ["best", "auto", "ell", "coo", "hyb", "cpg"])
def test_cli_each_format(fmt, capsys):
    rc, out = run(["-n", "600", "-b", "4", "-k", "20", "--dtype", "float64",
                   "--fmt", fmt, "--reorthogonalize"], capsys)
    assert rc == 0
    assert rel_of(out) < 1e-10


@pytest.mark.parametrize("flags,item", [
    (["--estrada", "8"], "queue 1 item 13"),
    (["--subgraph", "8"], "queue 1 item 13"),
    (["--dos", "8"], "queue 1 item 13"),
    (["--shards", "2"], "queue 1 item 14"),
    (["--fmt", "cst"], "queue 2 item 6"),
])
def test_cli_unported_flags_exit_2(flags, item, capsys):
    assert main(["-n", "200", "-e", "600", "--device", "cpu"] + flags) == 2
    assert item in capsys.readouterr().err


def test_cli_without_cuda_refuses_to_run_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["-n", "200", "-e", "600"]) != 0
    captured = capsys.readouterr()
    assert "--device cpu" in captured.err
    assert "device pipeline" not in captured.out
