"""The batched closed-loop controller: the Monte-Carlo and fleet-scale
execution engine.  Counterpart of `pigeon_tpu/parallel/mesh.py` on one
card: one shared trajectory tube and HJI cache, B independent scenario
states, `step` advancing every scenario one control period and `rollout`
a Python loop of steps whose logs stay on the device.

The JAX package shards the batch over a device mesh; the port runs on one
card, so `mesh` must be None (the multi-card controller is ROADMAP item
A6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import trajectory as trj

# the other car of `step` and `rollout` when the caller gives none: far
# away, so the HJI filter stays inactive
FAR_CAR = (1e4, 1e4, 0.0, 0.0)


class BatchState(NamedTuple):
    carry: mpc_mod.MPCCarry   # leading batch axis on every field
    q: torch.Tensor           # (B, 6) plant states
    u: torch.Tensor           # (B, 3) commands in effect


class BatchedController:
    """B scenarios in closed loop on the device of `tube`; `cache` None
    means the inactive cache."""

    def __init__(self, cfg: mpc_mod.MPCConfig, tube: trj.TrajectoryTube,
                 cache: "hji_mod.HJICache | None" = None, mesh=None,
                 dt: float = 0.01):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh of several cards is not ported (ROADMAP A6); the "
                "controller runs the whole batch on one card")
        self.cfg = cfg
        self.dt = dt
        self.tube = tube
        self.cache = (cache if cache is not None
                      else hji_mod.inactive_cache(device=tube.E.device))

    def init_state(self, q0_batch, u0_batch=None) -> BatchState:
        """Cold carries for the scenarios' plant states q0_batch (B, 6),
        whose dtype and device the state takes; commands u0_batch (B, 3)
        or zeros."""
        B = q0_batch.shape[0]
        carry = mpc_mod.init_carry(self.cfg, B, dtype=q0_batch.dtype,
                                   device=q0_batch.device)
        u0 = (torch.zeros_like(q0_batch[:, :3]) if u0_batch is None
              else u0_batch)
        return BatchState(carry=carry, q=q0_batch, u=u0)

    def _other(self, state: BatchState, other_car):
        if other_car is not None:
            return other_car
        return state.q.new_tensor(FAR_CAR).expand(state.q.shape[0], 4)

    def step(self, state: BatchState, other_car=None, t=0.0):
        """One control period for every scenario: the MPC step, then the
        plant advances with the command that was in effect.  t: a number
        or a (B,) tensor.  Returns (new state, diagnostics)."""
        q = state.q
        ts = torch.as_tensor(t, dtype=q.dtype, device=q.device)
        ts = ts.expand(q.shape[0]) if ts.dim() == 0 else ts
        carry, u3, diag = mpc_mod.mpc_step_batched(
            self.cfg, self.tube, self.cache, state.carry, q, state.u,
            self._other(state, other_car), ts)
        veh = self.cfg.veh
        ur = torch.cat([state.u[:, :1], state.u[:, 1:2] + state.u[:, 2:3],
                        torch.zeros_like(q[:, :4])], dim=-1)
        f = lambda qq, r: dyn.vehicle_ode(veh, "bicycle", qq, r[..., :2],
                                          r[..., 2:])
        q_next = dz.propagate(f, q, ur, self.dt, self.cfg.sim_substeps)
        return BatchState(carry=carry, q=q_next, u=u3), diag

    def advance_other(self, oc):
        """The other car one period on at constant velocity (heading
        measured from N, as the ego's)."""
        E, N, psi, V = oc.unbind(-1)
        return torch.stack([E - V * torch.sin(psi) * self.dt,
                            N + V * torch.cos(psi) * self.dt, psi, V],
                           dim=-1)

    def rollout(self, state: BatchState, n_steps: int, other_car=None,
                t0=0.0):
        """`n_steps` periods from `state`, the other car advancing at
        constant velocity; t0 a number or a (B,) tensor of per-scenario
        start times.  Returns (final state, (q_log, u_log, oc_log, diag)):
        the states and commands after each step (n_steps, B, ...), the
        other car during it and the stacked diagnostics, all on the
        device."""
        oc = self._other(state, other_car)
        t0 = torch.as_tensor(t0, dtype=state.q.dtype, device=state.q.device)
        q_log, u_log, oc_log, diags = [], [], [], []
        for i in range(n_steps):
            state, diag = self.step(state, oc, t0 + i * self.dt)
            q_log.append(state.q)
            u_log.append(state.u)
            oc_log.append(oc)
            diags.append(diag)
            oc = self.advance_other(oc)
        diag = mpc_mod.StepDiagnostics(*[torch.stack(x)
                                         for x in zip(*diags)])
        return state, (torch.stack(q_log), torch.stack(u_log),
                       torch.stack(oc_log), diag)
