"""The two controllers the configurations run, as plain batched code: the
coupled lateral+longitudinal sparse QP (Pigeon.jl X1CMPC,
src/coupled_lat_long.jl) and the decoupled lateral sparse QP (X1DMPC,
src/decoupled_lat_long.jl), each with its time grid, linearization
nodes, HJI row (coupled), exact stage discretization, QP assembly,
control extraction, actuator limits, the NaN fallback and the plant's
RK4 step.

QPs are in OSQP's form, minimize 1/2 x'Px + q'x subject to l <= Ax <= u,
P diagonal, with the variables and rows in the order of the layouts
below (the order the program's solver receives them in).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import hji as hj
from benchmark.reference import linearize as lz
from benchmark.reference import vehicle as vh
from benchmark.reference.precision import Arith
from benchmark.reference.world import Path

INF = math.inf
D10 = 10 * math.pi / 180


@dataclasses.dataclass(frozen=True)
class Gains:
    V_min: float = 1.0
    V_max: float = 15.0
    k_V: float = 10.0 / 4 / 100
    delta_dot_max: float = 0.344
    Q_ds: float = 1.0
    Q_dpsi: float = 1.0
    Q_e: float = 1.0
    W_beta: float = 50.0 / D10
    W_r: float = 50.0
    W_HJI: float = 500.0
    N_HJI: int = 3
    R_delta: float = 0.0
    R_ddelta: float = 0.1
    R_Fx: float = 0.0
    R_dFx: float = 0.5


COUPLED = Gains()
DECOUPLED = Gains(Q_dpsi=1.0 / D10 ** 2, R_ddelta=0.01 / D10 ** 2)


@dataclasses.dataclass(frozen=True)
class Spec:
    """One controller: formulation "coupled" or "decoupled", the horizon
    (N_short steps of dt_short, then N_long of dt_long aligned to the
    dt_long grid) and the HJI threshold."""
    formulation: str
    N_short: int
    N_long: int
    dt_short: float = 0.01
    dt_long: float = 0.2
    hji_eps: float = 0.05

    @property
    def N(self) -> int:
        return 1 + self.N_short + self.N_long

    @property
    def gains(self) -> Gains:
        return COUPLED if self.formulation == "coupled" else DECOUPLED

    @property
    def nx(self) -> int:
        return 6 if self.formulation == "coupled" else 4


SPECS = {"coupled_sparse": Spec("coupled", 5, 10),
         "decoupled_sparse": Spec("decoupled", 10, 20)}


# ---------------------------------------------------------------------------
# Layouts: variable blocks, rows, and the static positions of A's entries
# ---------------------------------------------------------------------------

class Layout:
    def __init__(self):
        self.n = self.m = 0
        self.entries = []          # (rows, cols) index arrays per value block
        self.groups = {}           # row group name -> row indices

    def vars(self, *shape):
        size = int(np.prod(shape))
        idx = np.arange(self.n, self.n + size).reshape(shape)
        self.n += size
        return idx

    def rows(self, count, group=None):
        idx = np.arange(self.m, self.m + count)
        self.m += count
        if group is not None:
            self.groups[group] = idx
        return idx

    def entry(self, rows, cols):
        r, c = np.broadcast_arrays(rows, cols)
        self.entries.append((r.ravel(), c.ravel()))

    def nonzeros(self) -> int:
        """Static nonzero positions of A."""
        pos = {(int(r), int(c)) for rr, cc in self.entries
               for r, c in zip(rr, cc)}
        return len(pos)

    def assemble(self, values, Bn, like):
        vals = torch.cat([v.reshape(Bn, -1) for v in values], dim=1)
        rows = np.concatenate([r for r, _ in self.entries])
        cols = np.concatenate([c for _, c in self.entries])
        if vals.shape[1] != rows.size:
            raise ValueError("A's values do not match the layout")
        A = torch.zeros((Bn, self.m, self.n), **like)
        dev = A.device
        A.index_put_((torch.arange(Bn, device=dev)[:, None],
                      torch.as_tensor(rows, device=dev)[None],
                      torch.as_tensor(cols, device=dev)[None]), vals,
                     accumulate=True)
        return A


def coupled_layout(sp: Spec) -> Layout:
    S, Lg, N = sp.N_short, sp.N_long, sp.N
    T = S + Lg
    L = Layout()
    L.q, L.u = L.vars(N, 6), L.vars(N, 2)
    L.sig, L.sHJI = L.vars(T, 2), L.vars(S)
    L.dd, L.dF = L.vars(T), L.vars(T)
    r = L.rows(T)
    L.entry(r, L.u[1:, 0]); L.entry(r, L.u[:-1, 0]); L.entry(r, L.dd)
    r = L.rows(T)
    L.entry(r, L.u[1:, 1]); L.entry(r, L.u[:-1, 1]); L.entry(r, L.dF)
    L.entry(L.rows(6), L.q[0])
    L.entry(L.rows(2), L.u[0])
    r = L.rows(6 * S).reshape(S, 6)
    L.entry(r[:, :, None], L.q[:S][:, None, :])
    L.entry(r[:, :, None], L.u[:S][:, None, :])
    L.entry(r, L.q[1:S + 1])
    r = L.rows(6 * Lg).reshape(Lg, 6)
    L.entry(r[:, :, None], L.q[S:S + Lg][:, None, :])
    L.entry(r[:, :, None], L.u[S:S + Lg][:, None, :])
    L.entry(r[:, :, None], L.u[S + 1:][:, None, :])
    L.entry(r, L.q[S + 1:])
    L.dyn_rows = np.arange(2 * T + 8, 2 * T + 8 + 6 * T).reshape(T, 6)
    L.entry(L.rows(2 * T), L.sig.ravel())
    L.entry(L.rows(S), L.sHJI)
    L.entry(L.rows(N), L.q[:, 1])
    L.entry(L.rows(N), L.u[:, 1])
    r = L.rows(S, "hji")
    L.entry(r[:, None], L.u[:S]); L.entry(r, L.sHJI)
    L.entry(L.rows(T), L.u[1:, 0])
    r = L.rows(4 * T).reshape(T, 4)
    L.env_rows = r
    L.entry(r[:, :, None], L.q[1:, 2:4][:, None, :])
    L.entry(r, L.sig[:, [0, 0, 1, 1]])
    L.entry(L.rows(T), L.dd)
    return L


def decoupled_layout(sp: Spec) -> Layout:
    S, Lg, N = sp.N_short, sp.N_long, sp.N
    T = S + Lg
    L = Layout()
    L.q, L.d = L.vars(N, 4), L.vars(N)
    L.sig, L.dd = L.vars(T, 2), L.vars(T)
    L.entry(L.rows(2 * T), L.sig.ravel())
    r = L.rows(T)
    L.entry(r, L.d[1:]); L.entry(r, L.d[:-1]); L.entry(r, L.dd)
    L.entry(L.rows(4), L.q[0])
    L.entry(L.rows(1), L.d[:1])
    r = L.rows(4 * S).reshape(S, 4)
    L.entry(r[:, :, None], L.q[:S][:, None, :])
    L.entry(r, np.broadcast_to(L.d[:S, None], (S, 4)))
    L.entry(r, L.q[1:S + 1])
    r = L.rows(4 * Lg).reshape(Lg, 4)
    L.entry(r[:, :, None], L.q[S:S + Lg][:, None, :])
    L.entry(r, np.broadcast_to(L.d[S:S + Lg, None], (Lg, 4)))
    L.entry(r, np.broadcast_to(L.d[S + 1:N, None], (Lg, 4)))
    L.entry(r, L.q[S + 1:])
    L.dyn_rows = np.arange(3 * T + 5, 3 * T + 5 + 4 * T).reshape(T, 4)
    L.entry(L.rows(T), L.d[1:])
    r = L.rows(4 * T).reshape(T, 4)
    L.env_rows = r
    L.entry(r[:, :, None], L.q[1:, 0:2][:, None, :])
    L.entry(r, L.sig[:, [0, 0, 1, 1]])
    L.entry(L.rows(T), L.dd)
    return L


def layout(sp: Spec) -> Layout:
    return (coupled_layout if sp.formulation == "coupled"
            else decoupled_layout)(sp)


# ---------------------------------------------------------------------------
# Time grid and linearization nodes
# ---------------------------------------------------------------------------

def time_grid(sp: Spec, t, shift=None):
    """Knot times (B, N) and steps (B, T): N_short steps of dt_short from
    t, then N_long of dt_long from the dt_long grid point after the short
    ones.  Also the distance of that grid choice from flipping (the
    argument of its ceil to the nearest integer); `shift` (B,) ints moves
    the choice by whole dt_long steps."""
    ar = lambda n: torch.arange(n, dtype=t.dtype, device=t.device)
    short = t[:, None] + sp.dt_short * ar(sp.N_short + 1)
    arg = (t + sp.N_short * sp.dt_short + sp.dt_short) / sp.dt_long - 1.0
    k = torch.ceil(arg)
    if shift is not None:
        k = k + shift
    long = (sp.dt_long * k)[:, None] + sp.dt_long * ar(sp.N_long + 1)[1:]
    ts = torch.cat([short, long], dim=-1)
    return ts, torch.diff(ts, dim=-1), (arg - torch.round(arg)).abs()


def _accel_desired(g: Gains, A_path, V_path, V, tau):
    A = A_path + g.k_V * (V_path - V) / tau
    return torch.clamp(A, (g.V_min - V) / tau, (g.V_max - V) / tau)


def _stage0(veh, q0, u0):
    V0c = q0[:, 3]
    Fyf0, _ = vh.lateral_forces(veh, q0[:, 3], q0[:, 4], q0[:, 5], u0)
    u20 = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)
    qdot = vh.ode(veh, "bicycle", q0, u20, None)
    return Fyf0, u20, qdot, V0c


def nodes_cold(sp: Spec, veh, path: Path, q0, u0, ts, dt, s0, e0):
    """Coupled trim-rollout nodes: stage 0 the measured state; short
    stages hold the measured (Ux, Uy, r, e) with the one-pass trim from
    the measured slip, long stages take the four-pass trim."""
    g, S, N = sp.gains, sp.N_short, sp.N
    p0 = path.at_arclength(s0)
    dpsi0 = hj.adiff(q0[:, 2], p0["psi"])
    Fyf0, u20, qdot, _ = _stage0(veh, q0, u0)
    sD, cD = torch.sin(dpsi0), torch.cos(dpsi0)
    V0 = q0[:, 3] * cD - q0[:, 4] * sD
    beta0, r0, delta0 = torch.atan2(q0[:, 4], q0[:, 3]), q0[:, 5], u0[:, 0]
    zero = 0.0 * s0
    ds0 = s0 - path.at_time(ts[:, 0])["s"]
    qs = [torch.stack([ds0, q0[:, 3], q0[:, 4], q0[:, 5], dpsi0, e0], -1)]
    us = [u20]
    ps = [torch.stack([p0["V"], p0["kappa"], zero, zero], -1)]
    A0 = ((qdot[:, 3] - q0[:, 5] * q0[:, 4]) * cD
          - (qdot[:, 4] + q0[:, 5] * q0[:, 3]) * sD)
    tau0 = dt[:, 0]
    V = V0 + A0 * tau0
    s = s0 + V * tau0 + A0 * tau0 * tau0 / 2.0
    taus = torch.cat([dt[:, 1:], dt[:, N - 2:N - 1]], dim=-1)
    for i in range(N - 1):
        tau = taus[:, i]
        pj = path.at_arclength(s)
        ds_i = s - path.at_time(ts[:, i + 1])["s"]
        A_des = _accel_desired(g, pj["A"], pj["V"], V, tau)
        if i < S:
            est = vh.trim(veh, V, A_des, pj["kappa"], 1, r=r0, beta0=beta0,
                          delta0=delta0, Fyf0=Fyf0)
            q = torch.stack([ds_i, q0[:, 3], q0[:, 4], q0[:, 5],
                             hj.adiff(q0[:, 2], pj["psi"]), e0], -1)
        else:
            est = vh.trim(veh, V, A_des, pj["kappa"], 4)
            q = torch.stack([ds_i, est.Ux, est.Uy, est.r, -est.beta, zero],
                            -1)
        qs.append(q)
        us.append(torch.stack([est.delta, est.Fxf + est.Fxr], -1))
        ps.append(torch.stack([pj["V"], pj["kappa"], zero, zero], -1))
        V = V + est.A * tau
        s = s + V * tau + est.A * tau * tau / 2.0
    return torch.stack(qs, 1), torch.stack(us, 1), torch.stack(ps, 1)


def nodes_warm(sp: Spec, veh, path: Path, q0, u0, ts, s0, e0, prev_ts,
               q_prev, u_prev, ar: Arith):
    """Coupled nodes resampled from the previous solution onto the new
    knot times (piecewise linear, clamped to its span); stage 0 the
    measured state."""
    p0 = path.at_arclength(s0)
    ds0 = s0 - path.at_time(ts[:, 0])["s"]
    zero = 0.0 * s0
    q_0 = torch.stack([ds0, q0[:, 3], q0[:, 4], q0[:, 5],
                       hj.adiff(q0[:, 2], p0["psi"]), e0], -1)
    u_0 = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], -1)
    p_0 = torch.stack([p0["V"], p0["kappa"], zero, zero], -1)
    K = prev_ts.shape[-1]
    tq = torch.minimum(torch.maximum(ts[:, 1:], prev_ts[:, :1]),
                       prev_ts[:, -1:])
    j = torch.clamp((tq[..., None] >= prev_ts[:, None, :]).sum(-1) - 1,
                    0, K - 2)
    t_j = torch.gather(prev_ts, 1, j)
    t_j1 = torch.gather(prev_ts, 1, j + 1)
    lam = torch.clamp((tq - t_j) / torch.clamp(t_j1 - t_j, min=1e-9),
                      0.0, 1.0)
    kk = torch.arange(K, device=ts.device)
    W = ((1.0 - lam)[..., None] * (kk == j[..., None]).to(lam.dtype)
         + lam[..., None] * (kk == (j + 1)[..., None]).to(lam.dtype))
    vals = ar.mm(W, torch.cat([q_prev, u_prev], dim=-1))
    q_tail, u_tail = vals[..., :6], vals[..., 6:]
    s_tail = path.at_time(ts[:, 1:])["s"] + q_tail[..., 0]
    pt = path.at_arclength(s_tail)
    p_tail = torch.stack([pt["V"], pt["kappa"], 0.0 * pt["V"],
                          0.0 * pt["V"]], -1)
    return (torch.cat([q_0[:, None], q_tail], 1),
            torch.cat([u_0[:, None], u_tail], 1),
            torch.cat([p_0[:, None], p_tail], 1))


def nodes_decoupled(sp: Spec, veh, path: Path, q0, u0, ts, dt, s0, e0):
    """Lateral nodes (Uy, r, dpsi, e) with parameters (Ux, kappa, ., .):
    stage 0 measured, short stages hold the measured (Uy, r, e) with the
    one-pass trim's controls, long stages the four-pass trim."""
    g, S, N = sp.gains, sp.N_short, sp.N
    Fyf0, u20, qdot, _ = _stage0(veh, q0, u0)
    V0 = torch.hypot(q0[:, 3], q0[:, 4])
    beta0, r0, delta0 = torch.atan2(q0[:, 4], q0[:, 3]), q0[:, 5], u0[:, 0]
    p0 = path.at_arclength(s0)
    zero = 0.0 * s0
    qs = [torch.stack([q0[:, 4], q0[:, 5], hj.adiff(q0[:, 2], p0["psi"]),
                       e0], -1)]
    us = [u20]
    ps = [torch.stack([q0[:, 3], p0["kappa"], zero, zero], -1)]
    A0 = ((qdot[:, 3] - q0[:, 5] * q0[:, 4]) * torch.cos(beta0)
          + (qdot[:, 4] + q0[:, 5] * q0[:, 3]) * torch.sin(beta0))
    tau0 = dt[:, 0]
    V = V0 + A0 * tau0
    s = s0 + V * tau0 + A0 * tau0 * tau0 / 2.0
    taus = torch.cat([dt[:, 1:], dt[:, N - 2:N - 1]], dim=-1)
    for i in range(N - 1):
        tau = taus[:, i]
        pj = path.at_arclength(s)
        A_des = _accel_desired(g, pj["A"], pj["V"], V, tau)
        if i < S:
            est = vh.trim(veh, V, A_des, pj["kappa"], 1, r=r0, beta0=beta0,
                          delta0=delta0, Fyf0=Fyf0)
            q = torch.stack([q0[:, 4], q0[:, 5],
                             hj.adiff(q0[:, 2], pj["psi"]), e0], -1)
        else:
            est = vh.trim(veh, V, A_des, pj["kappa"], 4)
            q = torch.stack([est.Uy, est.r, -est.beta, zero], -1)
        qs.append(q)
        us.append(torch.stack([est.delta, est.Fxf + est.Fxr], -1))
        ps.append(torch.stack([est.Ux, pj["kappa"], zero, zero], -1))
        V = V + est.A * tau
        s = s + V * tau + est.A * tau * tau / 2.0
    return torch.stack(qs, 1), torch.stack(us, 1), torch.stack(ps, 1)


# ---------------------------------------------------------------------------
# QP assembly
# ---------------------------------------------------------------------------

class QP(NamedTuple):
    P: torch.Tensor   # (B, n) diagonal
    q: torch.Tensor
    A: torch.Tensor   # (B, m, n)
    l: torch.Tensor
    u: torch.Tensor


# a stage's model or envelope that rounding decides: its node on an axle's
# friction circle (`vehicle.friction_margin`; the model at the node's
# limited force, the envelope at its force as given), or its envelope's
# corner lines at 0/0 (`vehicle.Envelope.cond`)
SINGULAR = vh.FRICTION_BAND
DEGENERATE = 1e-2


class Undetermined(NamedTuple):
    singular: torch.Tensor     # (B, T): stage t's model
    degenerate: torch.Tensor   # (B, T): stage t's envelope rows


def _hji_row_normalized(veh, M, b):
    """The row unit-normalized in the normalized-control metric, its
    bound kept within the reachable set."""
    unorm = torch.tensor(vh.u_normalization(veh), dtype=M.dtype,
                         device=M.device)
    Mn = M * unorm
    nrm = torch.sqrt((Mn * Mn).sum(-1))
    live = nrm > 1e-9
    scale = torch.where(live, 1.0 / torch.clamp(nrm, min=1e-9),
                        torch.ones_like(nrm))
    M, b = M * scale[:, None], b * scale
    l1 = Mn.abs().sum(-1) * scale
    return M, torch.where(live, torch.maximum(b, -0.95 * l1), b)


def coupled_qp(sp: Spec, veh, L: Layout, dt, qs, us, ps, M_hji, b_hji,
               ties, ar: Arith) -> QP:
    S, Lg, N = sp.N_short, sp.N_long, sp.N
    T, g = S + Lg, sp.gains
    Bn = qs.shape[0]
    like = dict(dtype=qs.dtype, device=qs.device)
    unorm = torch.tensor(vh.u_normalization(veh), **like)
    f = lambda q, ur: vh.ode(veh, "tracking", q, ur[..., :2], ur[..., 2:],
                             ties)
    foh = torch.arange(T, device=qs.device) >= S
    A_all, B0, Bf, c = lz.stages(f, qs, torch.cat([us, ps], -1), dt, foh, 2,
                                 ar)
    Ux_t = qs[:, 1:, 1]
    Fxf_t, Fxr_t = vh.split(veh, us[:, 1:, 1])
    env = vh.envelope(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(env.delta_min, min=-veh.delta_max) / unorm[0]
    d_max = torch.clamp(env.delta_max, max=veh.delta_max) / unorm[0]
    Fx_hi = torch.clamp(veh.Px_max / Ux_t, max=veh.Fx_max) / unorm[1]
    dd_lim = g.delta_dot_max * dt / unorm[0]
    ones = lambda *s: torch.ones((Bn,) + s, **like)
    values = [ones(T), -ones(T), -ones(T), ones(T), -ones(T), -ones(T),
              ones(6), ones(2),
              A_all[:, :S], B0[:, :S] * unorm, -ones(S, 6),
              A_all[:, S:], B0[:, S:] * unorm, Bf[:, S:] * unorm,
              -ones(Lg, 6),
              ones(2 * T), ones(S), ones(N), ones(N),
              (M_hji * unorm)[:, None, :].expand(Bn, S, 2), ones(S),
              ones(T), env.H.expand(Bn, T, 4, 2), -ones(T, 4), ones(T)]
    A = L.assemble(values, Bn, like)
    full = lambda k, v: torch.full((Bn, k), v, **like)
    cz = c.reshape(Bn, -1)
    lo = torch.cat([full(2 * T, 0.0), qs[:, 0], us[:, 0] / unorm, -cz,
                    full(2 * T + S, 0.0), full(N, g.V_min),
                    full(N, veh.Fx_min / float(unorm[1])),
                    (-b_hji)[:, None].expand(Bn, S), d_min,
                    full(4 * T, -INF), -dd_lim], dim=-1)
    hi = torch.cat([full(2 * T, 0.0), qs[:, 0], us[:, 0] / unorm, -cz,
                    full(2 * T + S, INF), full(N, g.V_max),
                    torch.cat([full(1, INF), Fx_hi], -1), full(S, INF),
                    d_max, env.Gv.reshape(Bn, -1), dd_lim], dim=-1)
    P = torch.zeros((Bn, L.n), **like)
    P[:, L.q[1:, 0]] = 2.0 * g.Q_ds * dt
    P[:, L.q[1:, 4]] = 2.0 * g.Q_dpsi * dt
    P[:, L.q[1:, 5]] = 2.0 * g.Q_e * dt
    P[:, L.u[1:, 0]] = 2.0 * g.R_delta * dt
    P[:, L.u[1:, 1]] = 2.0 * g.R_Fx * dt
    P[:, L.dd] = 2.0 * g.R_ddelta / dt
    P[:, L.dF] = 2.0 * g.R_dFx / dt
    qlin = torch.zeros((Bn, L.n), **like)
    qlin[:, L.sig[:, 0]] = g.W_beta * dt
    qlin[:, L.sig[:, 1]] = g.W_r * dt
    qlin[:, L.sHJI[:g.N_HJI]] = g.W_HJI
    und = Undetermined(
        vh.friction_margin(veh, vh.control_limits(
            veh, us[:, :T], qs[:, :T, 1])[..., 1]) <= SINGULAR,
        (env.cond <= DEGENERATE)
        | (vh.friction_margin(veh, us[:, 1:, 1]) <= SINGULAR))
    return QP(P, qlin, A, lo, hi), und


def decoupled_qp(sp: Spec, veh, L: Layout, dt, qs, us, ps, ties,
                 ar: Arith) -> QP:
    S, Lg, N = sp.N_short, sp.N_long, sp.N
    T, g = S + Lg, sp.gains
    Bn = qs.shape[0]
    like = dict(dtype=qs.dtype, device=qs.device)
    f = lambda q, ur: vh.ode(veh, "lateral", q, ur[..., :2], ur[..., 2:],
                             ties)
    foh = torch.arange(T, device=qs.device) >= S
    A_all, B0, Bf, c = lz.stages(f, qs, torch.cat([us, ps], -1), dt, foh, 1,
                                 ar)
    Fxf_t, Fxr_t = vh.split(veh, us[:, 1:, 1])
    env = vh.envelope(veh, ps[:, 1:, 0], Fxf_t, Fxr_t)
    d_min = torch.clamp(env.delta_min, min=-veh.delta_max)
    d_max = torch.clamp(env.delta_max, max=veh.delta_max)
    dd_lim = g.delta_dot_max * dt
    ones = lambda *s: torch.ones((Bn,) + s, **like)
    values = [ones(2 * T), ones(T), -ones(T), -ones(T), ones(4), ones(1),
              A_all[:, :S], B0[:, :S, :, 0], -ones(S, 4),
              A_all[:, S:], B0[:, S:, :, 0], Bf[:, S:, :, 0], -ones(Lg, 4),
              ones(T), env.H.expand(Bn, T, 4, 2), -ones(T, 4), ones(T)]
    A = L.assemble(values, Bn, like)
    full = lambda k, v: torch.full((Bn, k), v, **like)
    cz = c.reshape(Bn, -1)
    lo = torch.cat([full(3 * T, 0.0), qs[:, 0], us[:, 0, :1], -cz, d_min,
                    full(4 * T, -INF), -dd_lim], dim=-1)
    hi = torch.cat([full(2 * T, INF), full(T, 0.0), qs[:, 0], us[:, 0, :1],
                    -cz, d_max, env.Gv.reshape(Bn, -1), dd_lim], dim=-1)
    P = torch.zeros((Bn, L.n), **like)
    P[:, L.q[1:, 2]] = 2.0 * g.Q_dpsi * dt
    P[:, L.q[1:, 3]] = 2.0 * g.Q_e * dt
    P[:, L.d[1:]] = 2.0 * g.R_delta * dt
    P[:, L.dd] = 2.0 * g.R_ddelta / dt
    qlin = torch.zeros((Bn, L.n), **like)
    qlin[:, L.sig[:, 0]] = g.W_beta * dt
    qlin[:, L.sig[:, 1]] = g.W_r * dt
    und = Undetermined(
        vh.friction_margin(veh, vh.control_limits(
            veh, us[:, :T], ps[:, :T, 0])[..., 1]) <= SINGULAR,
        (env.cond <= DEGENERATE)
        | (vh.friction_margin(veh, us[:, 1:, 1]) <= SINGULAR))
    return QP(P, qlin, A, lo, hi), und


class Pre(NamedTuple):
    qp: QP
    ts: torch.Tensor
    us: torch.Tensor        # the nodes' controls (decoupled: Fx given)
    V_hji: torch.Tensor
    hji_ambiguous: torch.Tensor
    undetermined: Undetermined
    sensitivity: "torch.Tensor | None"   # (B, m), with `probe`


def _perturbed(x, rel: float):
    """x moved by `rel` (relative), up and down in turn entry by entry."""
    sign = 1.0 - 2.0 * (torch.arange(x[0].numel(), device=x.device)
                        .reshape(x.shape[1:]) % 2).to(x.dtype)
    return x * (1.0 + rel * sign)


def row_sensitivity(qp: QP, qp2: QP):
    """Each row's largest relative change between two QPs."""
    scale = torch.clamp(torch.maximum(qp.A.abs().amax(-1),
                                      qp2.A.abs().amax(-1)), min=1e-30)
    rel = lambda a, b: torch.nan_to_num(
        (a - b).abs() / torch.clamp(b.abs(), min=1.0), nan=0.0, posinf=0.0)
    return torch.maximum((qp.A - qp2.A).abs().amax(-1) / scale,
                         torch.maximum(rel(qp2.l, qp.l), rel(qp2.u, qp.u)))


def pre_solve(sp: Spec, veh, path: Path, grid: hj.Grid, q0, u0, other, t,
              solved, prev_ts, q_prev, u_prev, ties=vh.EXACT,
              ar: Arith = Arith(), shift=None, projection=None,
              probe: float = 0.0) -> Pre:
    """Projection, time grid, nodes (coupled: the warm ones where
    `solved`, else cold), the HJI row (coupled) and the QP.  `shift` and
    `projection` = (s0, e0) settle the time grid's choice where rounding
    decides it (`time_grid`) and give the projection (else it is worked
    out here).  With `probe`,
    also each row's sensitivity: its relative change when the nodes move
    by `probe` (relative), up and down in turn."""
    L = layout(sp)
    ts, dt, margin = time_grid(sp, t, shift)
    if projection is None:
        s0, e0, _ = path.project(q0[:, :2])
    else:
        s0, e0 = projection
    if sp.formulation == "decoupled":
        qs, us, ps = nodes_decoupled(sp, veh, path, q0, u0, ts, dt, s0, e0)
        qp, und = decoupled_qp(sp, veh, L, dt, qs, us, ps, ties, ar)
        sens = None
        if probe:
            qp2, _ = decoupled_qp(sp, veh, L, dt, *(
                _perturbed(x, probe) for x in (qs, us, ps)), ties, ar)
            sens = row_sensitivity(qp, qp2)
        inf = torch.full_like(t, INF)
        return Pre(qp, ts, us, inf, torch.zeros_like(solved), und, sens)
    cold = nodes_cold(sp, veh, path, q0, u0, ts, dt, s0, e0)
    warm = nodes_warm(sp, veh, path, q0, u0, ts, s0, e0, prev_ts, q_prev,
                      u_prev, ar)
    sel = solved[:, None, None]
    qs, us, ps = (torch.where(sel, w, c) for c, w in zip(cold, warm))
    M, b, V, _, _, amb = hj.row(veh, grid, q0, other, u0, sp.hji_eps, ties)
    M, b = _hji_row_normalized(veh, M, b)
    qp, und = coupled_qp(sp, veh, L, dt, qs, us, ps, M, b, ties, ar)
    sens = None
    if probe:
        qp2, _ = coupled_qp(sp, veh, L, dt, *(
            _perturbed(x, probe) for x in (qs, us, ps)), M, b, ties, ar)
        sens = row_sensitivity(qp, qp2)
    return Pre(qp, ts, us, V, amb, und, sens)


# ---------------------------------------------------------------------------
# After the solve: the command, the carry and the plant
# ---------------------------------------------------------------------------

def extract(sp: Spec, veh, L: Layout, x, us):
    """(delta, Fx) of the solution's second knot, and the solution's
    trajectory (states, physical controls) for the next step's nodes."""
    if sp.formulation == "coupled":
        unorm = torch.tensor(vh.u_normalization(veh), dtype=x.dtype,
                             device=x.device)
        return x[:, L.u[1]] * unorm, x[:, L.q], x[:, L.u] * unorm
    return (torch.stack([x[:, L.d[1]], us[:, 1, 1]], -1), x[:, L.q],
            torch.stack([x[:, L.d], us[:, :, 1]], -1))


def command(veh, u2, Ux, prev_command, prev_fallback):
    """The published (delta, Fxf, Fxr): the limited solution, or where it
    is not finite the last command (zero after a fallback)."""
    u2 = vh.control_limits(veh, u2, Ux)
    Fxf, Fxr = vh.split(veh, u2[:, 1])
    u3 = torch.stack([u2[:, 0], Fxf, Fxr], -1)
    finite = torch.isfinite(u3).all(-1)
    fallback = torch.where(prev_fallback[:, None], torch.zeros_like(u3),
                           prev_command)
    return torch.where(finite[:, None], u3, fallback), finite


def plant(veh, q, u3, dt: float):
    """One RK4 step of the world-frame bicycle under the command."""
    u2 = torch.stack([u3[:, 0], u3[:, 1] + u3[:, 2]], -1)
    f = lambda x: vh.ode(veh, "bicycle", x, u2, None)
    k1 = f(q)
    k2 = f(q + 0.5 * dt * k1)
    k3 = f(q + 0.5 * dt * k2)
    k4 = f(q + dt * k3)
    return q + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
