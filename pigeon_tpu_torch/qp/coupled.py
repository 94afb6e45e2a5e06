"""Coupled lateral+longitudinal tracking QP, batched over instances:
the stage data container and control normalization shared by its
formulations, and the sparse (hard-constraint) QP of
`pigeon_tpu/qp/coupled.py`.

Sparse QP variable layout (flat, 0-based stage t; N knots, T = N-1
stages):
    q[t, 0:6]   tracking state (ds, Ux, Uy, r, dpsi, e), t in [0, N)
    u[t, 0:2]   normalized controls (delta, Fx)/u_norm,   t in [0, N)
    sig[t, 0:2] envelope slacks (beta rows, r rows),       t in [0, T)
    sHJI[t]     HJI slack,                                 t in [0, S)
    dd[t]       delta slew,                                t in [0, T)
    dF[t]       Fx slew,                                   t in [0, T)
    sw[t]       wall slack (with `use_walls`),             t in [0, T)
Equality rows come first.  For the live horizon (N_short=5, N_long=10):
n = 193, m = 290, 128 equality rows; with the wall rows (sw >= 0 and the
two edge rows on e at each stage t+1, after the other rows) n = 208,
m = 335.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch.config import (CoupledControlParams, HorizonParams,
                                     VehicleParams)
from pigeon_tpu_torch.qp.structure import INF, QPLayout
from pigeon_tpu_torch.solver.admm import QPData


def u_normalization(veh: VehicleParams):
    """(delta, Fx) normalization to ~[-1, 1]
    (reference `src/coupled_lat_long.jl:199`)."""
    return np.array([veh.delta_max, max(-veh.Fx_min, veh.Fx_max)])


class CoupledStageData(NamedTuple):
    """Per-step assembly inputs, batched over a leading instance axis."""

    dt: torch.Tensor        # (B, T)
    qs: torch.Tensor        # (B, N, 6) linearization states
    us: torch.Tensor        # (B, N, 2) linearization controls (physical)
    ps: torch.Tensor        # (B, N, 4) trajectory params (V, kappa, 0, 0)
    hji_M: torch.Tensor     # (B, 2) constraint row on physical u
    hji_b: torch.Tensor     # (B,) offset
    edges: "torch.Tensor | None" = None   # (B, N, 2) [edge_L, edge_R]


class CoupledLayout:
    """Static sparsity plan for one horizon shape; build once, reuse."""

    def __init__(self, hz: HorizonParams, use_walls: bool = False):
        S, Lg = hz.N_short, hz.N_long
        N, T = hz.N, hz.N_short + hz.N_long
        self.hz = hz
        self.use_walls = use_walls
        lay = QPLayout()
        eq_rows = []
        self.q = lay.add_vars((N, 6))
        self.u = lay.add_vars((N, 2))
        self.sig = lay.add_vars((T, 2))
        self.sHJI = lay.add_vars((S,))
        self.dd = lay.add_vars((T,))
        self.dF = lay.add_vars((T,))

        # rows in allocation order; `build_qp` supplies each entry's values
        # in the same order.  Equality rows first.
        r = lay.add_rows(T)                         # diff(delta) == dd
        eq_rows.append(r)
        lay.entry(r, self.u[1:, 0]); lay.entry(r, self.u[:-1, 0])
        lay.entry(r, self.dd)
        r = lay.add_rows(T)                         # diff(Fx) == dF
        eq_rows.append(r)
        lay.entry(r, self.u[1:, 1]); lay.entry(r, self.u[:-1, 1])
        lay.entry(r, self.dF)
        r = lay.add_rows(6)                         # q[0] == q_curr
        eq_rows.append(r)
        lay.entry(r, self.q[0])
        r = lay.add_rows(2)                         # u[0] == u_curr
        eq_rows.append(r)
        lay.entry(r, self.u[0])
        r = lay.add_rows(6 * S).reshape(S, 6)       # ZOH dynamics
        eq_rows.append(r.ravel())
        lay.entry(r[:, :, None], self.q[:S][:, None, :])        # A_t
        lay.entry(r[:, :, None], self.u[:S][:, None, :])        # B_t
        lay.entry(r, self.q[1:S + 1])                           # -I q_{t+1}
        r = lay.add_rows(6 * Lg).reshape(Lg, 6)     # FOH dynamics
        eq_rows.append(r.ravel())
        lay.entry(r[:, :, None], self.q[S:S + Lg][:, None, :])  # A_t
        lay.entry(r[:, :, None], self.u[S:S + Lg][:, None, :])  # B0_t
        lay.entry(r[:, :, None], self.u[S + 1:][:, None, :])    # Bf_t
        lay.entry(r, self.q[S + 1:])                            # -I
        # ---- inequality rows ------------------------------------------
        r = lay.add_rows(2 * T)                     # sig >= 0
        lay.entry(r, self.sig.ravel())
        r = lay.add_rows(S)                         # sHJI >= 0
        lay.entry(r, self.sHJI)
        r = lay.add_rows(N)                         # V_min <= Ux <= V_max
        lay.entry(r, self.q[:, 1])
        r = lay.add_rows(N)                         # Fx bounds
        lay.entry(r, self.u[:, 1])
        r = lay.add_rows(S)                         # HJI half-planes
        lay.entry(r[:, None], self.u[:S])                       # M row
        lay.entry(r, self.sHJI)                                 # + slack
        r = lay.add_rows(T)                         # delta bounds on t+1
        lay.entry(r, self.u[1:, 0])
        r = lay.add_rows(4 * T).reshape(T, 4)       # envelope H [Uy,r]-sig
        lay.entry(r[:, :, None], self.q[1:, 2:4][:, None, :])   # H_t
        lay.entry(r, self.sig[:, [0, 0, 1, 1]])                 # -slacks
        r = lay.add_rows(T)                         # ddelta rate bounds
        lay.entry(r, self.dd)
        if use_walls:
            self.sw = lay.add_vars((T,))
            r = lay.add_rows(T)                     # sw >= 0
            lay.entry(r, self.sw)
            r = lay.add_rows(T)                     # e - sw <= edgeL - marg
            lay.entry(r, self.q[1:, 5]); lay.entry(r, self.sw)
            r = lay.add_rows(T)                     # e + sw >= edgeR + marg
            lay.entry(r, self.q[1:, 5]); lay.entry(r, self.sw)
        lay.finalize()
        self.lay = lay
        self.n, self.m = lay.n, lay.m
        self.eq_rows = np.concatenate(eq_rows)
        assert np.array_equal(self.eq_rows, np.arange(self.eq_rows.size))


@functools.lru_cache(maxsize=None)
def get_layout(hz: HorizonParams, use_walls: bool = False) -> CoupledLayout:
    return CoupledLayout(hz, use_walls)


def linearize_stages(f, hz: HorizonParams, qs, ur, dt, lin_method: str,
                     lin_substeps: int = 1, unbatched: bool = False):
    """The horizon's stage models of a batch: ZOH short stages, FOH long
    ones, as (A (B,T,n,n), B0 (B,T,n,2), Bf (B,T,n,2), c (B,T,n)), Bf
    zero on the ZOH stages.  lin_method "expm": one fused exponential per
    stage (`discretize.linearize_horizon_fused`; `unbatched` takes its
    dense route); "expm_split": each hold order's own exponential at 8
    squarings, order 8 (`linearize_affine_zoh` / `_foh`, on the dense
    expm kernel); any other: `lin_substeps` RK4 steps per stage,
    differentiated (`linearize_zoh` / `_foh`, plain ops)."""
    S, T = hz.N_short, hz.N_short + hz.N_long
    Bn, n = qs.shape[0], qs.shape[-1]
    if lin_method == "expm":
        return dz.linearize_horizon_fused(f, qs, ur, dt, S, 2, squarings=4,
                                          order=6, dense=unbatched)
    rows = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    zoh = (qs[:, :S], ur[:, :S], dt[:, :S])
    foh = (qs[:, S:T], ur[:, S:T], ur[:, S + 1:T + 1], dt[:, S:T])
    if lin_method == "expm_split":
        Az, Bz, cz = dz.linearize_affine_zoh(f, *map(rows, zoh), 2)
        Af, B0f, Bff, cf = dz.linearize_affine_foh(f, *map(rows, foh), 2)
    else:
        Az, Bz, cz = dz.linearize_zoh(f, *map(rows, zoh), 2, lin_substeps)
        Af, B0f, Bff, cf = dz.linearize_foh(f, *map(rows, foh), 2,
                                            lin_substeps)
    per = lambda x, k: x.reshape((Bn, k) + tuple(x.shape[1:]))
    Lg = T - S
    return (torch.cat([per(Az, S), per(Af, Lg)], dim=1),
            torch.cat([per(Bz, S), per(B0f, Lg)], dim=1),
            torch.cat([torch.zeros_like(per(Bz, S)), per(Bff, Lg)], dim=1),
            torch.cat([per(cz, S), per(cf, Lg)], dim=1))


def build_qp(veh: VehicleParams, ctl: CoupledControlParams,
             hz: HorizonParams, data: CoupledStageData,
             lin_method: str = "expm", lin_substeps: int = 1,
             unbatched: bool = False) -> QPData:
    """Linearize along the horizon and assemble the sparse QPs of a batch
    (`pigeon_tpu.qp.coupled.build_qp`): lin_method "expm" (ZOH short
    stages and FOH long stages through one fused exponential per stage),
    "expm_split" (each hold order's own exponential) or "rk4" (the
    reference's integrator path with `lin_substeps` RK4 steps per stage;
    `linearize_stages`).  With `ctl.use_walls`, `data.edges` gives the
    wall rows' bounds.  `unbatched` takes the dense linearization of the
    JAX package's single-vehicle step."""
    S, Lg, N = hz.N_short, hz.N_long, hz.N
    T = S + Lg
    L = get_layout(hz, ctl.use_walls)
    dt, qs, us, ps = data.dt, data.qs, data.us, data.ps
    Bn = qs.shape[0]
    like = dict(dtype=qs.dtype, device=qs.device)
    unorm = torch.as_tensor(u_normalization(veh), **like)

    def f(q, ur):
        return dyn.vehicle_ode(veh, "tracking", q, ur[..., :2], ur[..., 2:])

    ur = torch.cat([us, ps], dim=-1)                       # (B, N, 6)
    A_all, B0_all, Bf_all, c_all = linearize_stages(
        f, hz, qs, ur, dt, lin_method, lin_substeps, unbatched)
    Az, Bz, cz = A_all[:, :S], B0_all[:, :S], c_all[:, :S]
    Af, B0f, Bff, cf = (A_all[:, S:], B0_all[:, S:], Bf_all[:, S:],
                        c_all[:, S:])

    # per-stage envelope and bounds at the t+1 nodes
    Ux_t = qs[:, 1:, 1]                                    # (B, T)
    Fxf_t, Fxr_t = dyn.longitudinal_split(veh, us[:, 1:, 1])
    lim = dyn.stable_limits(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(lim.delta_min, min=-veh.delta_max) / unorm[0]
    d_max = torch.clamp(lim.delta_max, max=veh.delta_max) / unorm[0]
    Fx_hi = torch.clamp(veh.Px_max / Ux_t, max=veh.Fx_max) / unorm[1]
    dd_lim = ctl.delta_dot_max * dt / unorm[0]

    q_curr = qs[:, 0]
    u_curr = us[:, 0] / unorm

    ones = lambda *shape: torch.ones((Bn,) + shape, **like)
    neg1 = lambda *shape: -ones(*shape)
    values = [
        ones(T), neg1(T), neg1(T),                   # delta diff
        ones(T), neg1(T), neg1(T),                   # Fx diff
        ones(6),                                     # q pin
        ones(2),                                     # u pin
        Az, Bz * unorm, neg1(S, 6),                  # ZOH
        Af, B0f * unorm, Bff * unorm, neg1(Lg, 6),   # FOH
        ones(2 * T),                                 # sig >= 0
        ones(S),                                     # sHJI >= 0
        ones(N),                                     # Ux bounds
        ones(N),                                     # Fx bounds
        (data.hji_M * unorm)[:, None, :].expand(Bn, S, 2), ones(S),  # HJI
        ones(T),                                     # delta bounds
        lim.H_veh.to(qs.dtype).expand(Bn, T, 4, 2), neg1(T, 4),  # envelope
        ones(T),                                     # dd bounds
    ]
    if ctl.use_walls:
        values += [ones(T),                          # sw >= 0
                   ones(T), neg1(T),                 # e - sw
                   ones(T), ones(T)]                 # e + sw
    A = L.lay.assemble_A(values)

    full = lambda k, v: torch.full((Bn, k), v, **like)
    zeros = lambda k: full(k, 0.0)
    lo = torch.cat([
        zeros(T), zeros(T),                          # diffs
        q_curr, u_curr,
        -cz.reshape(Bn, -1),                         # ZOH equalities
        -cf.reshape(Bn, -1),                         # FOH equalities
        zeros(2 * T),                                # sig
        zeros(S),                                    # sHJI
        full(N, ctl.V_min),                          # Ux
        full(N, veh.Fx_min / float(u_normalization(veh)[1])),
        (-data.hji_b)[:, None].expand(Bn, S),        # HJI
        d_min,                                       # delta bounds
        full(4 * T, -INF),                           # envelope
        -dd_lim,                                     # dd bounds
    ] + ([zeros(T),                                  # sw >= 0
          full(T, -INF),                             # e - sw upper only
          data.edges[:, 1:, 1] + ctl.wall_margin,    # e + sw >= edgeR + m
          ] if ctl.use_walls else []), dim=-1)
    hi = torch.cat([
        zeros(T), zeros(T),
        q_curr, u_curr,
        -cz.reshape(Bn, -1),
        -cf.reshape(Bn, -1),
        full(2 * T, INF), full(S, INF),
        full(N, ctl.V_max),
        torch.cat([full(1, INF), Fx_hi], dim=-1),    # Fx: t=0 unbounded
        full(S, INF),
        d_max,
        lim.G_veh.to(qs.dtype).reshape(Bn, -1),      # envelope upper
        dd_lim,
    ] + ([full(T, INF),
          data.edges[:, 1:, 0] - ctl.wall_margin,    # e - sw <= edgeL - m
          full(T, INF),
          ] if ctl.use_walls else []), dim=-1)

    # objective: Parametron's x'Qx convention -> 1/2 x'Px needs P = 2Q
    P = torch.zeros((Bn, L.n), **like)
    P[:, L.q[1:, 0]] = 2.0 * ctl.Q_ds * dt
    P[:, L.q[1:, 4]] = 2.0 * ctl.Q_dpsi * dt
    P[:, L.q[1:, 5]] = 2.0 * ctl.Q_e * dt
    P[:, L.u[1:, 0]] = 2.0 * ctl.R_delta * dt
    P[:, L.u[1:, 1]] = 2.0 * ctl.R_Fx * dt
    P[:, L.dd] = 2.0 * ctl.R_ddelta / dt
    P[:, L.dF] = 2.0 * ctl.R_dFx / dt
    qlin = torch.zeros((Bn, L.n), **like)
    qlin[:, L.sig[:, 0]] = ctl.W_beta * dt
    qlin[:, L.sig[:, 1]] = ctl.W_r * dt
    qlin[:, L.sHJI] = torch.where(
        torch.arange(S, device=qs.device) < ctl.N_HJI,
        torch.full((S,), ctl.W_HJI, **like), torch.zeros((S,), **like))
    if ctl.use_walls:
        qlin[:, L.sw] = ctl.W_wall * dt
    return QPData(P_diag=P, q=qlin, A=A, l=lo, u=hi)


def extract_control(veh: VehicleParams, hz: HorizonParams, x,
                    use_walls: bool = False):
    """Next physical control (delta, Fx) per instance, x (B, n)
    (reference `get_next_control`, `src/coupled_lat_long.jl:370-374`)."""
    L = get_layout(hz, use_walls)
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    return x[:, L.u[1]] * unorm


def extract_trajectory(hz: HorizonParams, x, veh: VehicleParams,
                       use_walls: bool = False):
    """Full (q, u) solutions (B, N, 6), (B, N, 2) for warm-start
    resampling (reference `update_interpolations!`)."""
    L = get_layout(hz, use_walls)
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    return x[:, L.q], x[:, L.u] * unorm
