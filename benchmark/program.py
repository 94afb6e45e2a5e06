"""The system under test, `pigeon_tpu_torch`, through its entry points:
the configuration's controller (`mpc.x1_*_config` with its solver
options), the path (`trajectory.make_tube`), the value grid
(`hji_solve.load_cache`, or `hji.inactive_cache`), the fleet's
controller state (`mpc.init_carry`), the batched step
(`mpc.mpc_step_batched`) and the plant (`discretize.propagate` of
`dynamics.vehicle_ode`).  The kernels are built once into the package's
build directory inside the checkout.

`capture` hands each QP the step builds, at the solver's entry, to a
callback: the one place the harness reads inside the step.
"""

from __future__ import annotations

import contextlib

import torch


class Program:
    """One configuration's controller on `device`, on the path `cols`
    (numpy columns), with the value grid's file `value_grid` (None: the
    grid that never binds) and the plant's step `dt`."""

    def __init__(self, config: dict, cols: dict, value_grid, dt: float,
                 device):
        from pigeon_tpu_torch import hji, hji_solve, mpc, trajectory
        from pigeon_tpu_torch.config import SolverOptions

        self.cfg = getattr(mpc, config["controller"])(
            solver=SolverOptions(**config["solver"]))
        self.device = torch.device(device)
        self.dt = float(dt)
        self.tube = trajectory.make_tube(
            **cols, pad_to=int(config["world"]["pad_to"]), device=device)
        self.cache = (hji.inactive_cache(device=device) if value_grid is None
                      else hji_solve.load_cache(value_grid, device=device))

    @staticmethod
    def build_kernels():
        """Compile what the build directory does not hold yet; returns the
        sources compiled."""
        from pigeon_tpu_torch import _kernels

        return sorted(_kernels.build_all())

    def init_carry(self, batch: int):
        from pigeon_tpu_torch import mpc

        return mpc.init_carry(self.cfg, batch, device=self.device)

    def step(self, carry, q, u, oc, t):
        from pigeon_tpu_torch import mpc

        return mpc.mpc_step_batched(self.cfg, self.tube, self.cache, carry,
                                    q, u, oc, t)

    def plant(self, q, u3):
        """The bicycle one period on, under the command (delta, Fxf,
        Fxr)."""
        from pigeon_tpu_torch import discretize as dz
        from pigeon_tpu_torch import dynamics as dyn

        ur = torch.cat([u3[:, 0:1], u3[:, 1:2] + u3[:, 2:3],
                        torch.zeros_like(u3[:, :1]).expand(-1, 4)], dim=-1)
        veh = self.cfg.veh
        f = lambda x, r: dyn.vehicle_ode(veh, "bicycle", x, r[..., :2],
                                         r[..., 2:])
        return dz.propagate(f, q, ur, self.dt)

    @contextlib.contextmanager
    def capture(self, callback):
        """Within the block, every QP the step hands its solver goes to
        `callback(qp)` first (P diagonal, q, A, l, u)."""
        from pigeon_tpu_torch import mpc

        solve = mpc.solve_qp_batched

        def spy(qp, *args, **kw):
            callback(qp)
            return solve(qp, *args, **kw)

        mpc.solve_qp_batched = spy
        try:
            yield
        finally:
            mpc.solve_qp_batched = solve
