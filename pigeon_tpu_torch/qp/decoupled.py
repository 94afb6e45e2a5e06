"""Decoupled (lateral-only) tracking QPs, batched over instances.

Counterpart of `pigeon_tpu/qp/decoupled.py`: 4-state LTV lateral dynamics
(Uy, r, dpsi, e) with steering the single decision control; the
longitudinal force is the feedforward of the node seeding.  Two
formulations:

- the sparse QP (decoupled.py:35-172), the JAX package's default for
  `x1_decoupled_config()`: states, steering, envelope slacks and slews as
  variables, the dynamics as equality rows from the exact ZOH (short
  stages) and FOH (long stages) discretization of each stage.  For the
  decoupled horizon (N_short=10, N_long=20): n = 245, m = 395, 155 rows
  with l == u, not leading.  Variable layout (N knots, T = N-1 stages):
      q[t, 0:4]   lateral state (Uy, r, dpsi, e), t in [0, N)
      d[t]        steering angle (rad),            t in [0, N)
      sig[t, 0:2] envelope slacks,                 t in [0, T)
      dd[t]       steering slew,                   t in [0, T)
- the soft condensed QP (decoupled.py:175-354): as in the coupled soft QP
  (`qp/condensed.py`) the states are eliminated through the horizon
  dynamics, the q0 / delta0 pins are substituted, the envelope slacks
  become exact L1 penalties and the slew variables fold into the Hessian:
  n = 30 steering variables, m = 180 rows, no equality rows.  Row order:
  delta (T, hard) | envelope (4T, soft) | rate (T, hard).
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
from pigeon_tpu_torch.qp.structure import INF, QPLayout
from pigeon_tpu_torch.solver.admm import QPData


class DecoupledLayout:
    """Static sparsity plan of the sparse QP for one horizon shape: the
    variable blocks and the rows in `build_qp`'s order (the JAX package's
    `DecoupledLayout`)."""

    def __init__(self, hz: HorizonParams):
        S, Lg = hz.N_short, hz.N_long
        N, T = hz.N, S + Lg
        self.hz = hz
        lay = QPLayout()
        self.q = lay.add_vars((N, 4))
        self.d = lay.add_vars((N,))
        self.sig = lay.add_vars((T, 2))
        self.dd = lay.add_vars((T,))

        r = lay.add_rows(2 * T)                     # sig >= 0
        lay.entry(r, self.sig.ravel())
        r = lay.add_rows(T)                         # diff(delta) == dd
        lay.entry(r, self.d[1:]); lay.entry(r, self.d[:-1])
        lay.entry(r, self.dd)
        r = lay.add_rows(4)                         # q[0] == q_curr
        lay.entry(r, self.q[0])
        r = lay.add_rows(1)                         # d[0] == delta_curr
        lay.entry(r, self.d[:1])
        r = lay.add_rows(4 * S).reshape(S, 4)       # ZOH dynamics
        lay.entry(r[:, :, None], self.q[:S][:, None, :])        # A_t
        lay.entry(r, np.broadcast_to(self.d[:S, None], (S, 4)))  # B_t
        lay.entry(r, self.q[1:S + 1])                           # -I
        r = lay.add_rows(4 * Lg).reshape(Lg, 4)     # FOH dynamics
        lay.entry(r[:, :, None], self.q[S:S + Lg][:, None, :])
        lay.entry(r, np.broadcast_to(self.d[S:S + Lg, None], (Lg, 4)))
        lay.entry(r, np.broadcast_to(self.d[S + 1:N, None], (Lg, 4)))
        lay.entry(r, self.q[S + 1:])
        r = lay.add_rows(T)                         # delta bounds on t+1
        lay.entry(r, self.d[1:])
        r = lay.add_rows(4 * T).reshape(T, 4)       # envelope on (Uy, r)
        lay.entry(r[:, :, None], self.q[1:, 0:2][:, None, :])
        lay.entry(r, self.sig[:, [0, 0, 1, 1]])
        r = lay.add_rows(T)                         # slew bounds
        lay.entry(r, self.dd)
        lay.finalize()
        self.lay = lay
        self.n, self.m = lay.n, lay.m


@functools.lru_cache(maxsize=None)
def get_layout(hz: HorizonParams) -> DecoupledLayout:
    return DecoupledLayout(hz)


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


def build_qp(veh: VehicleParams, ctl: DecoupledControlParams,
             hz: HorizonParams, data: DecoupledStageData) -> QPData:
    """Linearize each stage exactly (ZOH on the N_short short stages, FOH
    on the long ones, each through `discretize.expm_dense` of its
    augmented matrix) and assemble the sparse QPs of a batch (the JAX
    package's `build_qp`, whose `vmap` over stages this batches over
    stages and vehicles alike: one exponential stack of B S 11 x 11 and
    one of B N_long 17 x 17)."""
    S, Lg, N = hz.N_short, hz.N_long, hz.N
    T = S + Lg
    L = get_layout(hz)
    dt, qs, us, ps = data.dt, data.qs, data.us, data.ps
    Bn = qs.shape[0]
    kw = dict(dtype=qs.dtype, device=qs.device)

    def f(q, ur):
        return dyn.vehicle_ode(veh, "lateral", q, ur[..., :2], ur[..., 2:])

    ur = torch.cat([us, ps], dim=-1)                       # (B, N, 6)
    flat = lambda t: t.reshape((-1,) + tuple(t.shape[2:]))
    Az, Bz, cz = dz.linearize_affine_zoh(
        f, flat(qs[:, :S]), flat(ur[:, :S]), flat(dt[:, :S]), 1)
    Af, B0f, Bff, cf = dz.linearize_affine_foh(
        f, flat(qs[:, S:T]), flat(ur[:, S:T]), flat(ur[:, S + 1:N]),
        flat(dt[:, S:T]), 1)
    per = lambda t, k: t.reshape((Bn, k) + tuple(t.shape[1:]))

    # envelope and bounds at the t+1 nodes
    Ux_t = ps[:, 1:, 0]
    Fxf_t, Fxr_t = dyn.longitudinal_split(veh, us[:, 1:, 1])
    lim = dyn.stable_limits(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(lim.delta_min, min=-veh.delta_max)
    d_max = torch.clamp(lim.delta_max, max=veh.delta_max)
    dd_lim = ctl.delta_dot_max * dt

    ones = lambda *shape: torch.ones((Bn,) + shape, **kw)
    neg1 = lambda *shape: -ones(*shape)
    values = [
        ones(2 * T),
        ones(T), neg1(T), neg1(T),
        ones(4), ones(1),
        per(Az, S), per(Bz[..., 0], S), neg1(S, 4),
        per(Af, Lg), per(B0f[..., 0], Lg), per(Bff[..., 0], Lg),
        neg1(Lg, 4),
        ones(T),
        lim.H_veh.to(qs.dtype).expand(Bn, T, 4, 2), neg1(T, 4),
        ones(T),
    ]
    A = L.lay.assemble_A(values)

    full = lambda k, v: torch.full((Bn, k), v, **kw)
    zeros = lambda k: full(k, 0.0)
    lo = torch.cat([
        zeros(2 * T),
        zeros(T),
        qs[:, 0], us[:, 0, :1],
        -cz.reshape(Bn, -1), -cf.reshape(Bn, -1),
        d_min,
        full(4 * T, -INF),
        -dd_lim,
    ], dim=-1)
    hi = torch.cat([
        full(2 * T, INF),
        zeros(T),
        qs[:, 0], us[:, 0, :1],
        -cz.reshape(Bn, -1), -cf.reshape(Bn, -1),
        d_max,
        lim.G_veh.to(qs.dtype).reshape(Bn, -1),
        dd_lim,
    ], dim=-1)

    # objective: 1/2 x'Px with P = 2Q (Parametron's x'Qx convention)
    P = torch.zeros((Bn, L.n), **kw)
    P[:, L.q[1:, 2]] = 2.0 * ctl.Q_dpsi * dt
    P[:, L.q[1:, 3]] = 2.0 * ctl.Q_e * dt
    P[:, L.d[1:]] = 2.0 * ctl.R_delta * dt
    P[:, L.dd] = 2.0 * ctl.R_ddelta / dt
    qlin = torch.zeros((Bn, L.n), **kw)
    qlin[:, L.sig[:, 0]] = ctl.W_beta * dt
    qlin[:, L.sig[:, 1]] = ctl.W_r * dt
    return QPData(P_diag=P, q=qlin, A=A, l=lo, u=hi)


def extract_control(hz: HorizonParams, x, us):
    """(delta, Fx) per instance of the sparse QP: steering from its second
    knot, Fx the feedforward of the node seeding.  x (B, n), us (B, N,
    2)."""
    L = get_layout(hz)
    return torch.stack([x[:, L.d[1]], us[:, 1, 1]], dim=-1)


def extract_trajectory(hz: HorizonParams, x, us):
    """Full (q, u) solutions (B, N, 4), (B, N, 2) of the sparse QP: the
    states and steering from x, Fx the node seeding's."""
    L = get_layout(hz)
    return x[:, L.q], torch.stack([x[:, L.d], us[:, :, 1]], dim=-1)


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
