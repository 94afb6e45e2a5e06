"""A run on the CPU at a small size (16 vehicles), without the card: the
sound program is correct; with its timed path broken underneath, or with
the TF32 control in its place, the comparison says not correct.  A later
PR's throwaway mix and metric run without an edit to any file there."""

import contextlib
import json
import math

import pytest
import torch

from benchmark import control, harness
from benchmark.program import Program

SECONDS = 1.0


def _run(root, workload="coupled-sparse.track", program=Program):
    return harness.run_cell(root, workload, 2**31 + 77, SECONDS, False,
                            "cpu", program=program)["result"]


@pytest.mark.parametrize("workload", ["coupled-sparse.track",
                                      "decoupled-sparse.track",
                                      "coupled-sparse.encounter"])
def test_sound_program_is_correct(small_root, workload):
    res = _run(small_root, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 16 and res["failed"] <= res["attempted"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"solves_per_s", "step_ms_p90", "setup_s"}


class _StaleState(Program):
    """The step hands back the state it was given."""

    def step(self, carry, q, u, oc, t):
        _, _, diag = super().step(carry, q, u, oc, t)
        return carry, carry.current_control, diag


class _PlantStands(Program):
    """The plant leaves the vehicles where they were."""

    def plant(self, q, u3):
        return q.clone()


class _HalfLeftOut(Program):
    """Half of the fleet's results are left out: their controller state
    and command stay as they were."""

    def step(self, carry, q, u, oc, t):
        new, u3, diag = super().step(carry, q, u, oc, t)
        h = q.shape[0] // 2
        keep = lambda a, b: torch.cat([a[:h], b[h:]])
        new = type(new)(*[keep(a, b) for a, b in zip(new, carry)])
        return new, keep(u3, carry.current_control), diag


class _AlteredCommand(Program):
    """Each command's steering altered by 0.01 rad where it is
    produced."""

    def step(self, carry, q, u, oc, t):
        new, u3, diag = super().step(carry, q, u, oc, t)
        u3 = u3 + torch.tensor([0.01, 0.0, 0.0], dtype=u3.dtype)
        return new._replace(current_control=u3), u3, diag


class _SolverFault(Program):
    """The solver is handed a changed QP, or changes its answer, beneath
    the harness's look at the QP it was given: `alter(qp)` and
    `answer(sol)`."""

    @contextlib.contextmanager
    def capture(self, callback):
        from pigeon_tpu_torch import mpc

        solve = mpc.solve_qp_batched

        def broken(qp, *args, **kw):
            callback(qp)
            return self.answer(solve(self.alter(qp), *args, **kw))

        mpc.solve_qp_batched = broken
        try:
            yield
        finally:
            mpc.solve_qp_batched = solve

    def alter(self, qp):
        return qp

    def answer(self, sol):
        return sol


class _Unbounded(_SolverFault):
    """The bounds left out: the QP solved with l = -inf and u = +inf, so
    z = Ax and y = 0, with residuals that are small and reported right."""

    def alter(self, qp):
        inf = torch.full_like(qp.l, math.inf)
        return qp._replace(l=-inf, u=inf)


class _NaNOnHardSolves(_SolverFault):
    """The solver gives up on its harder half, the solves that took the
    median number of iterations or more: their answers come back NaN,
    so their commands fall back."""

    def answer(self, sol):
        its = sol.iterations.float()
        bad = its >= its.median()
        nan = lambda v: torch.where(bad[:, None], math.nan, v)
        return sol._replace(x=nan(sol.x), y=nan(sol.y), z=nan(sol.z))


@pytest.mark.parametrize("fault", [_StaleState, _PlantStands, _HalfLeftOut,
                                   _AlteredCommand, _Unbounded,
                                   _NaNOnHardSolves])
def test_broken_timed_path_is_not_correct(small_root, fault):
    res = _run(small_root, program=fault)
    assert not res["correct"], res["checks"]


def test_unbounded_solver_fails_on_its_answer(small_root):
    """The QP and the command the comparison sees are right: only the
    answer's place in [l, u] gives the fault away."""
    res = _run(small_root, program=_Unbounded)
    checks = res["checks"]
    assert checks["det_gap"]["value"] <= checks["det_gap"]["limit"], checks
    assert checks["res_gap"]["value"] > checks["res_gap"]["limit"], checks


@pytest.mark.parametrize("workload", ["coupled-sparse.track",
                                      "decoupled-sparse.track"])
def test_tf32_control_is_not_correct(small_root, workload):
    rec = control.readings(small_root, workload, 5, 4, 8, False, "cpu")
    assert rec["correct"] is False, rec["checks"]


def test_a_throwaway_mix_and_metric_need_no_edit(small_root):
    bench = small_root / "benchmark"
    mix = json.loads((bench / "traffic" / "track.json").read_text())
    mix.update(speed_mps=7.0, start_knots=[100, 300], episode_periods=2)
    (bench / "traffic" / "throwaway.json").write_text(json.dumps(mix))
    (bench / "cells" / "coupled-sparse.throwaway.json").write_text(
        (bench / "cells" / "coupled-sparse.track.json").read_text())
    (bench / "metrics" / "throwaway_periods.py").write_text(
        "def read(rec):\n    return float(rec['periods'])\n")
    m = json.loads((small_root / "BENCHMARK.json").read_text())
    m["workloads"].append(dict(name="coupled-sparse.throwaway",
                               config="x1-coupled-sparse",
                               traffic="throwaway", chips=1, why="test"))
    m["per_layer"].append(dict(
        name="throwaway_periods", unit="periods", better="higher",
        source="host_clock", layer="device", moves="solves_per_s",
        workloads=["coupled-sparse.throwaway"]))
    (small_root / "BENCHMARK.json").write_text(json.dumps(m))
    res = harness.run_cell(small_root, "coupled-sparse.throwaway", 3,
                           SECONDS, True, "cpu")["result"]
    assert res["correct"], res["checks"]
    assert res["metrics"]["throwaway_periods"]["value"] >= 1
