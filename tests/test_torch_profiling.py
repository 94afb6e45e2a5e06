"""pigeon_tpu_torch.profiling against pigeon_tpu.profiling: the static
operation counts (`soft_step_flops`) equal the JAX package's; the
per-phase profile (`profile_step`) on the CPU at B = 4 gives the JAX
package's phase names with finite times, its phases run the step's own
pieces (the whole step's outputs equal `mpc_step_batched`'s) on each
backend; `mfu_row` against the H100's peaks; `torch_trace` writes a
Chrome trace; the module's entry point prints a profile row."""

import dataclasses
import json
import math
import sys

import pytest
import torch

from pigeon_tpu import profiling as JP
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import profiling as TP
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions

# pigeon_tpu/profiling.py's phase keys, check_every of the solver last
PHASES = ("nodes_warm", "nodes_cold", "linearize_assemble", "ruiz",
          "factor", "iterate_{k}", "residuals", "full_step")
SOLVERS = {
    "sparse_xla": (dict(), dict(max_iter=100, check_every=50, backend="xla",
                                factor_method="banded", scaling_iters=4)),
    "sparse_pallas": (dict(), dict(max_iter=100, check_every=50,
                                   backend="pallas", factor_method="banded",
                                   scaling_iters=4)),
    "soft_lanes": (dict(soft=True), dict(
        max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
        backend="lanes", scaling_iters=2, pallas_check_inner=10)),
}


@pytest.mark.parametrize("hz,n,m,iters,check", [
    ((5, 10), 30, 124, 62.2, 10), ((2, 3), 10, 44, 150.0, 150),
    ((4, 8), 24, 100, 33.3, 50), ((5, 10), 30, 139, 0.0, 1)])
def test_soft_step_flops_match(hz, n, m, iters, check):
    kw = dict(check_every=check, ns_polish=2, ruiz_iters=4)
    t = TP.soft_step_flops(THP(N_short=hz[0], N_long=hz[1]), n, m, iters,
                           **kw)
    j = JP.soft_step_flops(JHP(N_short=hz[0], N_long=hz[1]), n, m, iters,
                           **kw)
    assert t == j
    assert TP.soft_step_flops(THP(), n, m, iters) \
        == JP.soft_step_flops(JHP(), n, m, iters)


@pytest.mark.parametrize("name", list(SOLVERS))
def test_profile_step_phases(name):
    """B = 4 on the oval at float64, a warm carry: every phase named as
    in the JAX package, each time finite and positive, the whole step's
    outputs equal to `mpc_step_batched`'s on the same inputs."""
    cfg_kw, opts = SOLVERS[name]
    cfg = dataclasses.replace(TM.x1_coupled_config(**cfg_kw),
                              solver=SolverOptions(**opts))
    tube, cache, carry, q0, u0, oc, t = TP._fleet(cfg, 4, "cpu",
                                                  torch.float64)
    carry, _, _ = TM.mpc_step_batched(cfg, tube, cache, carry, q0, u0, oc, t)
    row = TP.profile_step(cfg, tube, cache, carry, q0, u0, oc, t, iters=2,
                          warmup=1, keep_outputs=True)
    k = opts["check_every"]
    assert tuple(row["phase_ms"]) == tuple(p.format(k=k) for p in PHASES)
    assert all(math.isfinite(v) and v > 0 for v in row["phase_ms"].values())
    assert (row["batch"], row["solver_backend"], row["platform"]) \
        == (4, opts["backend"], "cpu")
    full = row["outputs"]["full_step"]
    ref = TM.mpc_step_batched(cfg, tube, cache, carry, q0, u0, oc, t)
    for a, b in zip(full[1:], ref[1:]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert json.dumps({k: v for k, v in row.items() if k != "outputs"})


def test_profile_step_covers_the_coupled_step_only():
    cfg = TM.x1_decoupled_config(soft=True)
    tube, cache, carry, q0, u0, oc, t = TP._fleet(cfg, 2, "cpu")
    with pytest.raises(AssertionError, match="coupled"):
        TP.profile_step(cfg, tube, cache, carry, q0, u0, oc, t)


def test_mfu_row_h100():
    hz = THP()
    flops = TP.soft_step_flops(hz, 30, 124, 62.2)
    row = TP.mfu_row(8192, 0.030, flops)
    achieved = flops["total"] * 8192 / 0.030
    assert row["achieved_gflops"] == pytest.approx(achieved / 1e9)
    assert row["mfu_vs_fp32_pct"] == pytest.approx(
        100 * achieved / 67e12)
    assert row["mfu_vs_tf32_tensor_pct"] == pytest.approx(
        100 * achieved / 494.7e12)
    assert row["peaks_assumed"] is TP.PEAKS_H100
    assert "H100" in TP.PEAKS_H100["card"]
    assert not hasattr(TP, "PEAKS_V5E")
    assert json.dumps(row)


def test_torch_trace_writes_chrome_trace(tmp_path):
    with TP.torch_trace(str(tmp_path / "trace")) as logdir:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(f"{logdir}/trace.json") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_main_prints_a_profile_row(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["profiling", "--batch", "2",
                                      "--solver-iters", "10", "--device",
                                      "cpu"])
    TP._main()
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["solver_backend"] == "xla" and row["batch"] == 2
    assert set(row["phase_ms"]) == {p.format(k=10) for p in PHASES}


def test_mfu_main_prints_a_roofline_row(monkeypatch, capsys):
    """`--mfu`: the flagship soft step chained 10 times, its row against
    the H100's peaks (here on the CPU at B = 2)."""
    monkeypatch.setattr(sys, "argv", ["profiling", "--mfu", "--batch", "2",
                                      "--device", "cpu"])
    TP._main()
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["metric"] == "mfu_roofline" and row["batch"] == 2
    assert row["platform"] == "cpu" and row["step_ms"] > 0
    assert row["peaks_assumed"]["fp32_tflops"] == 67.0
