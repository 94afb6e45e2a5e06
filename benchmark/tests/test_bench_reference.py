"""The plain reference against the program run in float64 on the CPU
(B = 4, three closed-loop periods, cold then warm): the same QP up to the
program's truncated exponential (4 squarings, order 6), and the same
projection, residuals, command, carried state and plant step to
float64 rounding."""

import dataclasses
import json

import pytest
import torch

from conftest import ROOT
from benchmark import loop
from benchmark.reference.judge import Judge
from benchmark.reference.world import oval_columns


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs"
                       / f"{name}.json").read_text())


class _Float64Program:
    """The program's entry points at float64 on the CPU, its QP solved
    by the plain float64 ADMM ("xla")."""

    def __init__(self, cfg, cols):
        from pigeon_tpu_torch import hji, mpc, trajectory
        from pigeon_tpu_torch.config import SolverOptions

        opts = dataclasses.replace(SolverOptions(**cfg["solver"]),
                                   backend="xla")
        self.mpc = mpc
        self.cfg = getattr(mpc, cfg["controller"])(solver=opts)
        self.tube = trajectory.make_tube(**cols, pad_to=1024, device="cpu",
                                         dtype=torch.float64)
        self.cache = hji.inactive_cache(device="cpu")

    def step(self, carry, q, u, oc, t):
        return self.mpc.mpc_step_batched(self.cfg, self.tube, self.cache,
                                         carry, q, u, oc, t)


@pytest.mark.parametrize("name", ["x1-coupled-sparse",
                                  "x1-decoupled-sparse"])
def test_reference_matches_a_float64_step(name):
    from benchmark.program import Program
    from pigeon_tpu_torch import mpc

    cfg = _config(name)
    cols = oval_columns()
    prog = _Float64Program(cfg, cols)
    plant = Program.plant.__get__(type("P", (), dict(cfg=prog.cfg,
                                                     dt=0.01))())
    B = 4
    q = torch.tensor([[0.3, 10.0, 0.02, 6.0, 0.0, 0.0],
                      [-39.6, 30.0, 3.12, 6.0, 0.0, 0.0],
                      [-20.0, 79.7, 1.55, 6.5, 0.1, 0.05],
                      [-21.0, -19.5, 4.6, 5.5, -0.1, 0.0]],
                     dtype=torch.float64)
    st = dict(q=q, u=torch.zeros(B, 3, dtype=torch.float64),
              oc=torch.tensor([1e4, 1e4, 0.0, 0.0],
                              dtype=torch.float64).expand(B, 4),
              t=torch.tensor([1.25, 9.6, 12.4, 21.7], dtype=torch.float64))
    carry = mpc.init_carry(prog.cfg, B, dtype=torch.float64, device="cpu")
    sampler = loop.Sampler(torch.arange(B)[None])
    judge = Judge(cfg["reference"], cols, None, cfg["solver"], 0.01)
    import contextlib

    @contextlib.contextmanager
    def capture(cb):
        solve = mpc.solve_qp_batched
        mpc.solve_qp_batched = lambda qp, *a, **k: (cb(qp), solve(
            qp, *a, **k))[1]
        try:
            yield
        finally:
            mpc.solve_qp_batched = solve

    with capture(sampler.qp):
        for k in range(3):
            sampler.begin(0, carry, st)
            carry, u3, diag = prog.step(carry, st["q"], st["u"], st["oc"],
                                        st["t"])
            q_next = plant(st["q"], u3)
            sampler.end(carry, u3, diag, q_next)
            st = dict(q=q_next, u=u3, oc=st["oc"], t=st["t"] + 0.01)
    look = judge(sampler.collect())
    assert look["samples"] == 3 * B
    gaps = look["stage_gaps"]
    # the QP: the program's exponential truncates at order 6 after 4
    # squarings, 1e-8 to 1e-4 of a stage's entries where its norm is large
    assert gaps["qp"] < 1e-3, look["worst_row"]
    for stage in ("projection", "command", "carry", "plant", "solver"):
        assert gaps[stage] < 1e-9, (stage, gaps)
