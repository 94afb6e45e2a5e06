"""Soft condensed decoupled (lateral-only) tracking QP, batched over
instances.

Counterpart of the soft part of `pigeon_tpu/qp/decoupled.py`
(decoupled.py:175-354): 4-state LTV lateral dynamics (Uy, r, dpsi, e)
with steering the single decision control; the longitudinal force is the
feedforward of the node seeding.  As in the coupled soft QP
(`qp/condensed.py`) the states are eliminated through the horizon
dynamics, the q0 / delta0 pins are substituted, the envelope slacks
become exact L1 penalties and the slew variables fold into the Hessian.
For the decoupled horizon (N_short=10, N_long=20): n = 30 steering
variables, m = 180 rows, no equality rows.

Row order: delta (T, hard) | envelope (4T, soft) | rate (T, hard).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch.config import (DecoupledControlParams, HorizonParams,
                                     VehicleParams)
from pigeon_tpu_torch.qp.condensed import (SoftQP, rollout_affine,
                                            rollout_affine_unroll)
from pigeon_tpu_torch.qp.structure import INF


class SoftDecoupledLayout:
    """Static plan: variable u[t] is the steering angle at knot t+1, and
    the row ranges of each constraint family."""

    def __init__(self, hz: HorizonParams):
        N, T = hz.N, hz.N_short + hz.N_long
        self.hz = hz
        self.n = N - 1
        self.u = np.arange(N - 1)
        r0 = 0
        self.r_delta = np.arange(r0, r0 + T); r0 += T
        self.r_env = np.arange(r0, r0 + 4 * T).reshape(T, 4); r0 += 4 * T
        self.r_rate = np.arange(r0, r0 + T); r0 += T
        self.m = r0
        self.eq_rows = np.zeros((0,), np.int64)

        # entries of the identity and rate row families; rate stage 0
        # holds knot 1 only, stages t >= 1 hold delta_{t+1} - delta_t
        rows = [self.r_delta, self.r_rate[0:1],
                np.repeat(self.r_rate[1:], 2)]
        cols = [self.u[:T], self.u[0:1],
                np.stack([self.u[1:T], self.u[0:T - 1]], axis=-1).ravel()]
        self._sp_rows = np.concatenate(rows)
        self._sp_cols = np.concatenate(cols)
        self._sp_vals = np.concatenate([
            np.ones(T), np.ones(1), np.tile(np.asarray([1.0, -1.0]), T - 1)])


@functools.lru_cache(maxsize=None)
def get_soft_layout(hz: HorizonParams) -> SoftDecoupledLayout:
    return SoftDecoupledLayout(hz)


class DecoupledStageData(NamedTuple):
    """Per-step assembly inputs, batched over a leading instance axis."""

    dt: torch.Tensor        # (B, T)
    qs: torch.Tensor        # (B, N, 4) lateral states at the nodes
    us: torch.Tensor        # (B, N, 2) (delta, Fx) at the nodes (physical)
    ps: torch.Tensor        # (B, N, 4) (Ux, kappa, 0, 0)


def build_qp_soft(veh: VehicleParams, ctl: DecoupledControlParams,
                  hz: HorizonParams, data: DecoupledStageData,
                  unbatched: bool = False) -> SoftQP:
    """Assemble the soft condensed decoupled QPs of a batch; G is
    (B, T, 4, n) here.  `unbatched` takes the route of the JAX package's
    single-vehicle step: the dense linearization
    (`discretize.linearize_horizon_fused`) and the sequential rollout
    instead of the rollout kernel."""
    S = hz.N_short
    T = S + hz.N_long
    L = get_soft_layout(hz)
    dt, qs, us, ps = data.dt, data.qs, data.us, data.ps
    Bn = qs.shape[0]
    dtype, dev = qs.dtype, qs.device
    kw = dict(dtype=dtype, device=dev)
    n = L.n

    def f(q, ur):
        return dyn.vehicle_ode(veh, "lateral", q, ur[..., :2], ur[..., 2:])

    ur = torch.cat([us, ps], dim=-1)
    A_all, B0_all, Bf_all, c_all = dz.linearize_horizon_fused(
        f, qs, ur, dt, S, 1, squarings=4, order=6, dense=unbatched)

    d_curr = us[:, 0, 0]
    q_curr = qs[:, 0]

    # rollout over the free steering knots, pins folded into the offset:
    # q_{t+1} = G[t] d_free + g[t], d_free the steering at knots 1..N-1.
    # Column n of E carries the affine part.  Stage t's B0 lands on column
    # t-1 and its Bf on column t: distinct entries, so plain assignments
    # (two index tensors around a slice put the indexed dimension first).
    E = torch.zeros((Bn, T, 4, n + 1), **kw)
    E[:, 0, :, 0] = Bf_all[:, 0, :, 0]
    tt = torch.arange(1, T, device=dev)
    E[:, tt, :, tt - 1] = B0_all[:, 1:, :, 0].transpose(0, 1)
    E[:, tt, :, tt] = Bf_all[:, 1:, :, 0].transpose(0, 1)
    e0 = (torch.einsum("bij,bj->bi", A_all[:, 0], q_curr) + c_all[:, 0]
          + B0_all[:, 0, :, 0] * d_curr[:, None])
    E[:, :, :, n] = torch.cat([e0[:, None], c_all[:, 1:]], dim=1)
    rollout = rollout_affine_unroll if unbatched else rollout_affine
    M_cum = rollout(A_all.contiguous(), E)
    G = M_cum[..., :n]                                  # (B, T, 4, n)
    g = M_cum[..., n]                                   # (B, T, 4)

    # envelope and bounds at the t+1 nodes
    Ux_t = ps[:, 1:, 0]
    Fxf_t, Fxr_t = dyn.longitudinal_split(veh, us[:, 1:, 1])
    lim = dyn.stable_limits(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(lim.delta_min, min=-veh.delta_max)
    d_max = torch.clamp(lim.delta_max, max=veh.delta_max)
    dd_lim = ctl.delta_dot_max * dt

    H_veh = lim.H_veh.to(dtype)
    Henv = torch.einsum("btij,btjk->btik", H_veh, G[:, :, 0:2, :])
    Henv_off = torch.einsum("btij,btj->bti", H_veh, g[:, :, 0:2])

    A = torch.zeros((Bn, L.m, n), **kw)
    A[:, L.r_env.ravel()] = Henv.reshape(Bn, 4 * T, n)
    A[:, torch.as_tensor(L._sp_rows, device=dev),
      torch.as_tensor(L._sp_cols, device=dev)] = torch.as_tensor(
          L._sp_vals, **kw)

    full = lambda k, v: torch.full((Bn, k), v, **kw)
    lo = torch.cat([
        d_min,
        full(4 * T, -INF),
        d_curr[:, None] - dd_lim[:, 0:1], -dd_lim[:, 1:],
    ], dim=-1)
    hi = torch.cat([
        d_max,
        (lim.G_veh - Henv_off).reshape(Bn, -1),
        d_curr[:, None] + dd_lim[:, 0:1], dd_lim[:, 1:],
    ], dim=-1)

    # soft-row weights: the envelope slacks' linear costs; the first slew
    # row is soft because its anchor d_curr is external and can sit outside
    # the envelope's steering bound (see qp/condensed.py build_qp_soft)
    w_env = torch.stack([ctl.W_beta * dt, ctl.W_beta * dt,
                         ctl.W_r * dt, ctl.W_r * dt], dim=-1)   # (B, T, 4)
    w = torch.cat([full(T, INF), w_env.reshape(Bn, -1),
                   full(1, 1e3), full(T - 1, INF)], dim=-1)

    # ---- objective --------------------------------------------------------
    # state tracking (Q_dpsi, Q_e on rows 2:4) through the rollout
    Wst = 2.0 * dt[..., None] * torch.stack(
        [torch.full_like(dt, ctl.Q_dpsi), torch.full_like(dt, ctl.Q_e)],
        dim=-1)                                                 # (B, T, 2)
    Gsel = G[:, :, 2:4, :]
    gsel = g[:, :, 2:4]
    P = torch.einsum("btkn,btk,btkm->bnm", Gsel, Wst, Gsel)
    qlin = torch.einsum("btkn,btk,btk->bn", Gsel, Wst, gsel)
    P = P + torch.diag_embed(2.0 * ctl.R_delta * dt)

    # slew quadratic: sum_t (R_ddelta/dt_t)(d_{t+1} - d_t)^2, d_0 pinned
    if ctl.R_ddelta != 0.0:
        cw = 2.0 * ctl.R_ddelta / dt                            # (B, T)
        vidx = L.u[:T]
        v0 = int(vidx[0])
        P[:, v0, v0] += cw[:, 0]
        qlin[:, v0] += -cw[:, 0] * d_curr
        a, b_ = vidx[1:], vidx[:-1]
        P[:, a, a] += cw[:, 1:]
        P[:, b_, b_] += cw[:, 1:]
        P[:, a, b_] += -cw[:, 1:]
        P[:, b_, a] += -cw[:, 1:]

    return SoftQP(P=P, q=qlin, A=A, l=lo, u=hi, w=w, G=G, g=g)


def extract_control_soft(hz: HorizonParams, x, us):
    """(delta, Fx) per instance: steering from the first free knot, Fx the
    feedforward of the node seeding.  x (B, n), us (B, N, 2)."""
    return torch.stack([x[:, 0], us[:, 1, 1]], dim=-1)


def extract_trajectory_soft(hz: HorizonParams, x, G, g, q_curr, us):
    """Full (q, u) solutions (B, N, 4), (B, N, 2): states through the
    rollout map, knot 0 the pinned current state and steering."""
    q_tail = torch.einsum("btij,bj->bti", G, x) + g
    q_sol = torch.cat([q_curr[:, None], q_tail], dim=1)
    d_sol = torch.cat([us[:, 0:1, 0], x], dim=-1)
    u_sol = torch.stack([d_sol, us[:, :, 1]], dim=-1)
    return q_sol, u_sol
