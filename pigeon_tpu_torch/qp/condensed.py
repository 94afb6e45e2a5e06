"""Condensed coupled tracking QPs, batched over instances.

Counterpart of `pigeon_tpu/qp/condensed.py`.  States are eliminated
through the horizon dynamics, q_{t+1} = G_t [q0; u] + g_t, so the state
tracking cost becomes a dense quadratic block.  Two formulations:

- the hard condensed QP (condensed.py:50-307, 310, 791;
  `x1_coupled_config(condensed=True)`): the sparse QP's variables but the
  states, q0 and u0 pinned by equality rows, the slacks kept as
  variables, a dense P = Gsel' W Gsel; for the live horizon
  (N_short=5, N_long=10) n = 103, m = 200, the 38 equality rows first.
  Row order: diff(delta) (T), diff(Fx) (T), q0 pin (6), u0 pin (2) |
  sig >= 0 (2T), sHJI >= 0 (S), Ux t=0 (1), Ux t>=1 (T, dense over
  [q0; u]), Fx (N), HJI (S), delta (T), envelope (4T, dense), rate (T)
  [| sw >= 0 (T), e - sw <= edge_L - margin (T, dense), e + sw >= edge_R
  + margin (T, dense): the wall rows, n = 118, m = 245].
- the soft condensed QP (condensed.py:322-395, 563-788): the q0/u0 pins
  substituted, every slack an exact L1 penalty handled by the solver's
  shrink prox, the slew variables folded into the dense Hessian; n = 30,
  m = 124, no equality rows.  Row order: ux (T, hard dense) | fx (N-1,
  hard) | hji (S-1, soft) | delta (T, hard) | envelope (4T, soft) |
  rate (T, hard) [| walls (T, soft and two-sided: m = 139)].
Both take lin_method "expm" or the RK4 path; every other lin_method,
"expm_split" too, takes the RK4 path, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch.config import (CoupledControlParams, HorizonParams,
                                     VehicleParams)
from pigeon_tpu_torch.qp.coupled import (CoupledStageData, linearize_stages,
                                         u_normalization)
from pigeon_tpu_torch.qp.structure import INF, QPLayout


# ---------------------------------------------------------------------------
# The hard condensed QP
# ---------------------------------------------------------------------------

class CondensedLayout:
    """Static plan: variable indices, the row allocation (equalities
    first) and the [q0; u] column map of the dense condensed rows."""

    def __init__(self, hz: HorizonParams, use_walls: bool = False):
        S = hz.N_short
        N, T = hz.N, hz.N_short + hz.N_long
        lay = QPLayout()
        eq_rows = []
        self.q0 = lay.add_vars((6,))
        self.u = lay.add_vars((N, 2))
        self.sig = lay.add_vars((T, 2))
        self.sHJI = lay.add_vars((S,))
        self.dd = lay.add_vars((T,))
        self.dF = lay.add_vars((T,))
        # [q0; u] column order of the dense rollout rows (contiguous: q0
        # then u)
        self.gcols = np.concatenate([self.q0, self.u.ravel()])
        nG = self.gcols.size                        # 6 + 2N

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
        r = lay.add_rows(6)                         # q0 == q_curr
        eq_rows.append(r)
        lay.entry(r, self.q0)
        r = lay.add_rows(2)                         # u0 == u_curr
        eq_rows.append(r)
        lay.entry(r, self.u[0])
        # ---- inequality rows ------------------------------------------
        r = lay.add_rows(2 * T)                     # sig >= 0
        lay.entry(r, self.sig.ravel())
        r = lay.add_rows(S)                         # sHJI >= 0
        lay.entry(r, self.sHJI)
        r = lay.add_rows(1)                         # Ux bound t=0 (on q0)
        lay.entry(r, self.q0[1])
        r = lay.add_rows(T).reshape(T, 1)           # Ux bounds t>=1: dense
        lay.entry(np.broadcast_to(r, (T, nG)), self.gcols[None, :])
        r = lay.add_rows(N)                         # Fx bounds
        lay.entry(r, self.u[:, 1])
        r = lay.add_rows(S)                         # HJI half-planes
        lay.entry(r[:, None], self.u[:S])
        lay.entry(r, self.sHJI)
        r = lay.add_rows(T)                         # delta bounds t>=1
        lay.entry(r, self.u[1:, 0])
        r = lay.add_rows(4 * T).reshape(T, 4)       # envelope: dense rows
        lay.entry(np.broadcast_to(r[:, :, None], (T, 4, nG)),
                  self.gcols[None, None, :])
        lay.entry(r, self.sig[:, [0, 0, 1, 1]])     # -slacks
        r = lay.add_rows(T)                         # ddelta rate bounds
        lay.entry(r, self.dd)
        if use_walls:
            self.sw = lay.add_vars((T,))
            r = lay.add_rows(T)                     # sw >= 0
            lay.entry(r, self.sw)
            r = lay.add_rows(T).reshape(T, 1)       # e - sw <= edgeL - m
            lay.entry(np.broadcast_to(r, (T, nG)), self.gcols[None, :])
            lay.entry(r[:, 0], self.sw)
            r = lay.add_rows(T).reshape(T, 1)       # e + sw >= edgeR + m
            lay.entry(np.broadcast_to(r, (T, nG)), self.gcols[None, :])
            lay.entry(r[:, 0], self.sw)
        lay.finalize()
        self.lay = lay
        self.n, self.m = lay.n, lay.m
        self.eq_rows = np.concatenate(eq_rows)
        assert np.array_equal(self.eq_rows, np.arange(self.eq_rows.size))


@functools.lru_cache(maxsize=None)
def get_layout(hz: HorizonParams, use_walls: bool = False
               ) -> CondensedLayout:
    return CondensedLayout(hz, use_walls)


class CondensedQP(NamedTuple):
    """Dense-P QPs and the rollout map for state recovery, batched."""

    P: torch.Tensor        # (B, n, n) dense Hessian (1/2 x'Px convention)
    q: torch.Tensor        # (B, n)
    A: torch.Tensor        # (B, m, n)
    l: torch.Tensor        # (B, m)
    u: torch.Tensor        # (B, m)
    G: torch.Tensor        # (B, T, 6, 6+2N) state rollout map over [q0; u]
    g: torch.Tensor        # (B, T, 6) rollout offsets


def _stage_models(f, hz, qs, ur, dt, lin_method, lin_substeps, unbatched):
    """The condensed QPs' stage models: "expm" as the sparse QP's, every
    other lin_method ("expm_split" too, as in the JAX package) the RK4
    path with `lin_substeps`."""
    return linearize_stages(f, hz, qs, ur, dt,
                            "expm" if lin_method == "expm" else "rk4",
                            lin_substeps, unbatched)


def build_qp(veh: VehicleParams, ctl: CoupledControlParams,
             hz: HorizonParams, data: CoupledStageData,
             lin_method: str = "expm", lin_substeps: int = 1,
             unbatched: bool = False) -> CondensedQP:
    """Linearize along the horizon, roll the LTV models into the dense
    [q0; u] map and assemble the hard condensed QPs of a batch
    (`pigeon_tpu.qp.condensed.build_qp`; `_stage_models`).  The rollout
    is the JAX package's static unroll, a loop over the T stages.  With
    `ctl.use_walls`, `data.edges` gives the wall rows' bounds.
    `unbatched` takes the dense linearization of the JAX package's
    single-vehicle step."""
    S, N = hz.N_short, hz.N
    T = S + hz.N_long
    L = get_layout(hz, ctl.use_walls)
    dt, qs, us, ps = data.dt, data.qs, data.us, data.ps
    Bn = qs.shape[0]
    like = dict(dtype=qs.dtype, device=qs.device)
    unorm = torch.as_tensor(u_normalization(veh), **like)

    def f(q, ur):
        return dyn.vehicle_ode(veh, "tracking", q, ur[..., :2], ur[..., 2:])

    ur = torch.cat([us, ps], dim=-1)
    A_all, B0_all, Bf_all, c_all = _stage_models(
        f, hz, qs, ur, dt, lin_method, lin_substeps, unbatched)
    B0n = B0_all * unorm
    Bfn = Bf_all * unorm

    # ---- rollout map: q_{t+1} = G[t] [q0; u] + g[t] -------------------
    Gp = torch.cat([torch.eye(6, **like).expand(Bn, 6, 6),
                    torch.zeros((Bn, 6, 2 * N), **like)], dim=-1)
    gp = torch.zeros((Bn, 6), **like)
    G_list, g_list = [], []
    for t in range(T):
        Gn = A_all[:, t] @ Gp
        c0 = 6 + 2 * t
        Gn[:, :, c0:c0 + 2] += B0n[:, t]
        Gn[:, :, c0 + 2:c0 + 4] += Bfn[:, t]
        gn = _mv(A_all[:, t], gp) + c_all[:, t]
        G_list.append(Gn)
        g_list.append(gn)
        Gp, gp = Gn, gn
    G = torch.stack(G_list, dim=1)                   # (B, T, 6, nG)
    g = torch.stack(g_list, dim=1)                   # (B, T, 6)

    # per-stage envelope and bounds at the t+1 node states
    Ux_t = qs[:, 1:, 1]
    Fxf_t, Fxr_t = dyn.longitudinal_split(veh, us[:, 1:, 1])
    lim = dyn.stable_limits(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(lim.delta_min, min=-veh.delta_max) / unorm[0]
    d_max = torch.clamp(lim.delta_max, max=veh.delta_max) / unorm[0]
    Fx_hi = torch.clamp(veh.Px_max / Ux_t, max=veh.Fx_max) / unorm[1]
    dd_lim = ctl.delta_dot_max * dt / unorm[0]

    q_curr = qs[:, 0]
    u_curr = us[:, 0] / unorm

    H_veh = lim.H_veh.to(qs.dtype).expand(Bn, T, 4, 2)
    Henv = torch.einsum("btij,btjk->btik", H_veh, G[:, :, 2:4, :])
    Henv_off = torch.einsum("btij,btj->bti", H_veh, g[:, :, 2:4])

    ones = lambda *shape: torch.ones((Bn,) + shape, **like)
    neg1 = lambda *shape: -ones(*shape)
    values = [
        ones(T), neg1(T), neg1(T),                   # delta diff
        ones(T), neg1(T), neg1(T),                   # Fx diff
        ones(6),                                     # q0 pin
        ones(2),                                     # u0 pin
        ones(2 * T),                                 # sig >= 0
        ones(S),                                     # sHJI >= 0
        ones(1),                                     # Ux t=0
        G[:, :, 1, :],                               # Ux t>=1 (dense)
        ones(N),                                     # Fx bounds
        (data.hji_M * unorm)[:, None, :].expand(Bn, S, 2), ones(S),  # HJI
        ones(T),                                     # delta bounds
        Henv, neg1(T, 4),                            # envelope (dense)
        ones(T),                                     # dd bounds
    ]
    if ctl.use_walls:
        values += [ones(T),                          # sw >= 0
                   G[:, :, 5, :], neg1(T),           # e - sw
                   G[:, :, 5, :], ones(T)]           # e + sw
    A = L.lay.assemble_A(values)

    full = lambda k, v: torch.full((Bn, k), v, **like)
    zeros = lambda k: full(k, 0.0)
    lo = torch.cat([
        zeros(T), zeros(T),                          # diffs
        q_curr, u_curr,                              # pins
        zeros(2 * T),                                # sig
        zeros(S),                                    # sHJI
        full(1, ctl.V_min),                          # Ux t=0
        ctl.V_min - g[:, :, 1],                      # Ux t>=1
        full(N, veh.Fx_min / float(u_normalization(veh)[1])),
        (-data.hji_b)[:, None].expand(Bn, S),        # HJI
        d_min,
        full(4 * T, -INF),                           # envelope
        -dd_lim,
    ] + ([zeros(T),
          full(T, -INF),
          data.edges[:, 1:, 1] + ctl.wall_margin - g[:, :, 5],
          ] if ctl.use_walls else []), dim=-1)
    hi = torch.cat([
        zeros(T), zeros(T),
        q_curr, u_curr,
        full(2 * T, INF), full(S, INF),
        full(1, ctl.V_max),
        ctl.V_max - g[:, :, 1],
        torch.cat([full(1, INF), Fx_hi], dim=-1),    # Fx: t=0 unbounded
        full(S, INF),
        d_max,
        (lim.G_veh.to(qs.dtype) - Henv_off).reshape(Bn, -1),
        dd_lim,
    ] + ([full(T, INF),
          data.edges[:, 1:, 0] - ctl.wall_margin - g[:, :, 5],
          full(T, INF),
          ] if ctl.use_walls else []), dim=-1)

    # ---- objective --------------------------------------------------------
    # state tracking cost folded through the rollout: a dense block over
    # [q0; u] (Parametron's x'Qx convention -> 1/2 x'Px needs P = 2Q)
    Wst = 2.0 * dt[..., None] * torch.stack(
        [torch.full_like(dt, ctl.Q_ds), torch.full_like(dt, ctl.Q_dpsi),
         torch.full_like(dt, ctl.Q_e)], dim=-1)                # (B, T, 3)
    sel = torch.tensor([0, 4, 5], device=qs.device)
    Gsel = G[:, :, sel, :]                                     # (B, T, 3, nG)
    gsel = g[:, :, sel]                                        # (B, T, 3)
    Pblock = torch.einsum("btkn,btk,btkm->bnm", Gsel, Wst, Gsel)
    qblock = torch.einsum("btkn,btk,btk->bn", Gsel, Wst, gsel)

    gc = torch.as_tensor(L.gcols, device=qs.device)
    bidx = torch.arange(Bn, device=qs.device)[:, None, None]
    P = torch.zeros((Bn, L.n, L.n), **like).index_put_(
        (bidx, gc[None, :, None], gc[None, None, :]), Pblock,
        accumulate=True)
    diag = torch.zeros((Bn, L.n), **like)
    diag[:, L.u[1:, 0]] = 2.0 * ctl.R_delta * dt
    diag[:, L.u[1:, 1]] = 2.0 * ctl.R_Fx * dt
    diag[:, L.dd] = 2.0 * ctl.R_ddelta / dt
    diag[:, L.dF] = 2.0 * ctl.R_dFx / dt
    P = P + torch.diag_embed(diag)
    qlin = torch.zeros((Bn, L.n), **like)
    qlin[:, gc] += qblock
    qlin[:, L.sig[:, 0]] += ctl.W_beta * dt
    qlin[:, L.sig[:, 1]] += ctl.W_r * dt
    qlin[:, L.sHJI] += torch.where(
        torch.arange(S, device=qs.device) < ctl.N_HJI,
        torch.full((S,), ctl.W_HJI, **like), torch.zeros((S,), **like))
    if ctl.use_walls:
        qlin[:, L.sw] += ctl.W_wall * dt
    return CondensedQP(P=P, q=qlin, A=A, l=lo, u=hi, G=G, g=g)


def extract_control(veh: VehicleParams, hz: HorizonParams, x,
                    use_walls: bool = False):
    """Next physical control (delta, Fx) per instance, x (B, n)
    (reference `get_next_control`)."""
    L = get_layout(hz, use_walls)
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    return x[:, L.u[1]] * unorm


def extract_trajectory(hz: HorizonParams, x, veh: VehicleParams, G, g,
                       use_walls: bool = False):
    """Full (q, u) solutions (B, N, 6), (B, N, 2) for warm-start
    resampling: the states through the rollout map
    q_{t+1} = G_t [q0; u] + g_t."""
    L = get_layout(hz, use_walls)
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    q_tail = torch.einsum("btij,bj->bti", G, x[:, L.gcols]) + g
    q_sol = torch.cat([x[:, L.q0][:, None], q_tail], dim=1)
    return q_sol, x[:, L.u] * unorm


class SoftCondensedLayout:
    """Static plan: variable index of each normalized (delta, Fx) knot and
    the row ranges of each constraint family."""

    def __init__(self, hz: HorizonParams, use_walls: bool = False):
        S = hz.N_short
        N, T = hz.N, hz.N_short + hz.N_long
        self.n = 2 * (N - 1)
        self.u = np.arange(2 * (N - 1)).reshape(N - 1, 2)  # u[t-1] = knot t
        r0 = 0
        self.r_ux = np.arange(r0, r0 + T); r0 += T
        self.r_fx = np.arange(r0, r0 + (N - 1)); r0 += N - 1
        self.r_hji = np.arange(r0, r0 + (S - 1)); r0 += S - 1
        self.r_delta = np.arange(r0, r0 + T); r0 += T
        self.r_env = np.arange(r0, r0 + 4 * T).reshape(T, 4); r0 += 4 * T
        self.r_rate = np.arange(r0, r0 + T); r0 += T
        if use_walls:
            self.r_wall = np.arange(r0, r0 + T); r0 += T
        self.m = r0
        self.eq_rows = np.zeros((0,), np.int64)

        # scatter indices of the sparse row families
        rows, cols = [], []
        rows.append(self.r_fx); cols.append(self.u[:, 1])
        rows.append(np.repeat(self.r_hji, 2))
        cols.append(self.u[:S - 1].ravel())
        rows.append(self.r_delta); cols.append(self.u[:T, 0])
        # rate rows: stage 0 -> u1 only; stages t>=1 -> u_{t+1} - u_t
        rows.append(self.r_rate[0:1]); cols.append(self.u[0:1, 0])
        rows.append(np.repeat(self.r_rate[1:], 2))
        cols.append(np.stack([self.u[1:T, 0], self.u[0:T - 1, 0]],
                             axis=-1).ravel())
        self._sp_rows = np.concatenate(rows)
        self._sp_cols = np.concatenate(cols)


@functools.lru_cache(maxsize=None)
def get_soft_layout(hz: HorizonParams, use_walls: bool = False
                    ) -> SoftCondensedLayout:
    return SoftCondensedLayout(hz, use_walls)


class SoftQP(NamedTuple):
    """Equality-free QPs with per-row exact-penalty weights (inf = hard
    row) and the rollout map for state recovery, batched."""

    P: torch.Tensor        # (B, n, n) dense Hessian (1/2 x'Px convention)
    q: torch.Tensor        # (B, n)
    A: torch.Tensor        # (B, m, n)
    l: torch.Tensor        # (B, m)
    u: torch.Tensor        # (B, m)
    w: torch.Tensor        # (B, m) soft-row penalty weights
    G: torch.Tensor        # (B, T, 6, n) rollout map over free u
    g: torch.Tensor        # (B, T, 6) offsets (pins folded in)


# Horizon length from which the rollout takes the associative scan (the
# JAX package's threshold); the kernel covers the horizons below it.
ROLLOUT_SCAN_MIN_T = 64

# The rollout kernel holds a column of M in registers for d up to this.
ROLLOUT_D_MAX = 6


def rollout_affine_unroll(A_all, E):
    """Plain PyTorch version of the rollout: the sequential recursion
    M_0 = E_0, M_t = A_t M_{t-1} + E_t over (B, T, d, d), (B, T, d, w)."""
    M = E[:, 0]
    out = [M]
    for t in range(1, E.shape[1]):
        M = A_all[:, t] @ M + E[:, t]
        out.append(M)
    return torch.stack(out, dim=1)


def rollout_affine_scan(A_all, E):
    """The rollout's recursion as an associative scan over the horizon
    (`pigeon_tpu.qp.condensed.rollout_affine_scan`): ceil(log2 T) rounds
    of batched (d, d) @ (d, d) and (d, d) @ (d, w) products, a
    Hillis-Steele doubling with the combine (A2, M2) o (A1, M1) =
    (A2 A1, A2 M1 + M2).  Round k combines every stage t >= 2^k with
    stage t - 2^k; torch ops on any device (XLA code in the JAX package,
    no kernel)."""
    A, M = A_all, E
    T = E.shape[1]
    k = 1
    while k < T:
        A_new = A[:, k:] @ A[:, :-k]
        M_new = A[:, k:] @ M[:, :-k] + M[:, k:]
        A = torch.cat([A[:, :k], A_new], dim=1)
        M = torch.cat([M[:, :k], M_new], dim=1)
        k *= 2
    return M


def rollout_affine(A_all, E):
    """Cumulative affine rollout per instance: A_all (B, T, d, d),
    E (B, T, d, w) -> M (B, T, d, w).  From T = `ROLLOUT_SCAN_MIN_T` on,
    on any device, the associative scan (`rollout_affine_scan`), as the
    JAX package switches; below it CUDA tensors (float32, contiguous)
    launch `csrc/rollout.cu`, one thread per (instance, column), and CPU
    tensors run `rollout_affine_unroll`.

    Replaces the TPU kernel
    `pigeon_tpu/qp/condensed.py:_rollout_lane_kernel`.  It moves
    4 T d (d + 2 w) bytes and does 2 T d^2 w FLOP per instance: bound by
    bytes (259 MB at B=8192, T=30, d=4, w=31)."""
    if A_all.dim() != 4 or E.dim() != 4:
        raise ValueError(f"A_all must be (B, T, d, d) and E (B, T, d, w), "
                         f"got {tuple(A_all.shape)}, {tuple(E.shape)}")
    B, T, d, w = E.shape
    _kernels.check_same(A_all=(A_all, (B, T, d, d)), E=(E, (B, T, d, w)))
    if T >= ROLLOUT_SCAN_MIN_T:
        return rollout_affine_scan(A_all, E)
    if E.device.type == "cpu":
        return rollout_affine_unroll(A_all, E)
    _kernels.check_cuda_f32(A_all=A_all, E=E)
    if d > ROLLOUT_D_MAX:
        raise ValueError(f"the CUDA kernel takes d <= {ROLLOUT_D_MAX}, "
                         f"got {d}")
    out = torch.empty_like(E)
    _kernels.KERNELS["rollout"].launch(A_all, E, out, B, T, d, w)
    return out


def _mv(M, v):
    return torch.einsum("...ij,...j->...i", M, v)


def build_qp_soft(veh: VehicleParams, ctl: CoupledControlParams,
                  hz: HorizonParams, data: CoupledStageData,
                  lin_method: str = "expm", lin_substeps: int = 1,
                  unbatched: bool = False) -> SoftQP:
    """Assemble the soft condensed QPs of a batch
    (`pigeon_tpu.qp.condensed.build_qp_soft`, static unroll;
    `_stage_models`).  With `ctl.use_walls`, one two-sided soft row a
    stage keeps e within [edge_R + margin, edge_L - margin] at weight
    W_wall dt.  `unbatched` takes the dense linearization of the JAX
    package's single-vehicle step (`discretize.linearize_horizon_fused`)."""
    S, N = hz.N_short, hz.N
    T = S + hz.N_long
    L = get_soft_layout(hz, ctl.use_walls)
    dt, qs, us, ps = data.dt, data.qs, data.us, data.ps
    Bn = qs.shape[0]
    dtype, dev = qs.dtype, qs.device
    f64 = dict(dtype=dtype, device=dev)
    unorm = torch.as_tensor(u_normalization(veh), **f64)
    n = L.n

    def f(q, ur):
        return dyn.vehicle_ode(veh, "tracking", q, ur[..., :2], ur[..., 2:])

    ur = torch.cat([us, ps], dim=-1)
    A_all, B0_all, Bf_all, c_all = _stage_models(
        f, hz, qs, ur, dt, lin_method, lin_substeps, unbatched)
    B0n = B0_all * unorm
    Bfn = Bf_all * unorm

    q_curr = qs[:, 0]
    u_curr = us[:, 0] / unorm

    # rollout over the free u columns, pins folded into the offset:
    # q_{t+1} = G[t] u_free + g[t]
    Gp = torch.zeros((Bn, 6, n), **f64)
    gp = q_curr
    G_list, g_list = [], []
    for t in range(T):
        Gn = A_all[:, t] @ Gp
        gn = _mv(A_all[:, t], gp) + c_all[:, t]
        if t == 0:
            # B0 multiplies the pinned u0; Bf the first free knot
            gn = gn + _mv(B0n[:, 0], u_curr)
            Gn[:, :, 0:2] += Bfn[:, 0]
        else:
            c0 = 2 * (t - 1)
            Gn[:, :, c0:c0 + 2] += B0n[:, t]
            Gn[:, :, c0 + 2:c0 + 4] += Bfn[:, t]
        G_list.append(Gn)
        g_list.append(gn)
        Gp, gp = Gn, gn
    G = torch.stack(G_list, dim=1)                   # (B, T, 6, n)
    g = torch.stack(g_list, dim=1)                   # (B, T, 6)

    # per-stage envelope and bounds at the t+1 node states
    Ux_t = qs[:, 1:, 1]
    Fxf_t, Fxr_t = dyn.longitudinal_split(veh, us[:, 1:, 1])
    lim = dyn.stable_limits(veh, Ux_t, Fxf_t, Fxr_t)
    d_min = torch.clamp(lim.delta_min, min=-veh.delta_max) / unorm[0]
    d_max = torch.clamp(lim.delta_max, max=veh.delta_max) / unorm[0]
    Fx_hi = torch.clamp(veh.Px_max / Ux_t, max=veh.Fx_max) / unorm[1]
    Fx_lo = torch.full((Bn, N - 1),
                       veh.Fx_min / float(u_normalization(veh)[1]), **f64)
    dd_lim = ctl.delta_dot_max * dt / unorm[0]

    H_veh = lim.H_veh.to(dtype)
    Henv = torch.einsum("btij,btjk->btik", H_veh, G[:, :, 2:4, :])
    Henv_off = torch.einsum("btij,btj->bti", H_veh, g[:, :, 2:4])

    # ---- constraint matrix ------------------------------------------------
    A = torch.zeros((Bn, L.m, n), **f64)
    A[:, L.r_ux] = G[:, :, 1, :]
    A[:, L.r_env.ravel()] = Henv.reshape(Bn, 4 * T, n)
    if ctl.use_walls:
        A[:, L.r_wall] = G[:, :, 5, :]
    sp_vals = torch.cat([
        torch.ones((Bn, N - 1), **f64),                       # fx
        (data.hji_M * unorm)[:, None, :].expand(Bn, S - 1, 2)
        .reshape(Bn, -1),                                      # hji
        torch.ones((Bn, T), **f64),                            # delta
        torch.ones((Bn, 1), **f64),                            # rate t=0
        torch.tensor([1.0, -1.0], **f64).repeat(T - 1).expand(Bn, -1),
    ], dim=-1)
    rows = torch.as_tensor(L._sp_rows, device=dev)
    cols = torch.as_tensor(L._sp_cols, device=dev)
    A[:, rows, cols] += sp_vals

    full = lambda k, v: torch.full((Bn, k), v, **f64)
    lo = torch.cat([
        ctl.V_min - g[:, :, 1],                                # ux
        Fx_lo,                                                 # fx
        (-data.hji_b)[:, None].expand(Bn, S - 1),              # hji
        d_min,                                                 # delta
        full(4 * T, -INF),                                     # envelope
        u_curr[:, 0:1] - dd_lim[:, 0:1], -dd_lim[:, 1:],       # rate
    ] + ([data.edges[:, 1:, 1] + ctl.wall_margin - g[:, :, 5]]
         if ctl.use_walls else []), dim=-1)
    hi = torch.cat([
        ctl.V_max - g[:, :, 1],
        Fx_hi,
        full(S - 1, INF),
        d_max,
        (lim.G_veh - Henv_off).reshape(Bn, -1),
        u_curr[:, 0:1] + dd_lim[:, 0:1], dd_lim[:, 1:],
    ] + ([data.edges[:, 1:, 0] - ctl.wall_margin - g[:, :, 5]]
         if ctl.use_walls else []), dim=-1)

    # ---- per-row penalty weights (the slack costs of the slack QP) -------
    w_hji = torch.where(torch.arange(1, S, device=dev) < ctl.N_HJI,
                        torch.full((S - 1,), ctl.W_HJI, **f64),
                        torch.zeros((S - 1,), **f64))
    w_env = torch.stack([ctl.W_beta * dt, ctl.W_beta * dt,
                         ctl.W_r * dt, ctl.W_r * dt], dim=-1)  # (B, T, 4)
    # the first slew row anchors on the externally commanded u_curr; a
    # large exact penalty keeps it binding when feasible and least-violated
    # when an override makes it disjoint from the hard delta bound
    w = torch.cat([
        full(T, INF),                                          # ux hard
        full(N - 1, INF),                                      # fx hard
        w_hji.expand(Bn, -1),
        full(T, INF),                                          # delta hard
        w_env.reshape(Bn, -1),
        full(1, 1e3), full(T - 1, INF),                        # rate
    ] + ([ctl.W_wall * dt] if ctl.use_walls else []), dim=-1)

    # ---- objective ----------------------------------------------------------
    # state tracking cost folded through the rollout (P = 2Q convention)
    Wst = 2.0 * dt[..., None] * torch.stack(
        [torch.full_like(dt, ctl.Q_ds), torch.full_like(dt, ctl.Q_dpsi),
         torch.full_like(dt, ctl.Q_e)], dim=-1)                # (B, T, 3)
    sel = torch.tensor([0, 4, 5], device=dev)
    Gsel = G[:, :, sel, :]                                     # (B, T, 3, n)
    gsel = g[:, :, sel]                                        # (B, T, 3)
    P = torch.einsum("btkn,btk,btkm->bnm", Gsel, Wst, Gsel)
    qlin = torch.einsum("btkn,btk,btk->bn", Gsel, Wst, gsel)

    diag = torch.zeros((Bn, n), **f64)
    diag[:, L.u[:, 0]] = 2.0 * ctl.R_delta * dt
    diag[:, L.u[:, 1]] = 2.0 * ctl.R_Fx * dt
    P = P + torch.diag_embed(diag)

    # slew quadratics: sum_t (R/dt_t)(v_{t+1} - v_t)^2, v_0 pinned to u_curr
    for k, R in ((0, ctl.R_ddelta), (1, ctl.R_dFx)):
        if R == 0.0:
            continue
        cw = 2.0 * R / dt                                      # (B, T)
        vidx = L.u[:, k]
        v0 = int(vidx[0])
        P[:, v0, v0] += cw[:, 0]
        qlin[:, v0] += -cw[:, 0] * u_curr[:, k]
        a, b_ = vidx[1:], vidx[:-1]
        P[:, a, a] += cw[:, 1:]
        P[:, b_, b_] += cw[:, 1:]
        P[:, a, b_] += -cw[:, 1:]
        P[:, b_, a] += -cw[:, 1:]

    return SoftQP(P=P, q=qlin, A=A, l=lo, u=hi, w=w, G=G, g=g)


def extract_control_soft(veh: VehicleParams, hz: HorizonParams, x,
                         use_walls: bool = False):
    """Next physical control (delta, Fx) per instance, x (B, n)."""
    L = get_soft_layout(hz, use_walls)
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    return x[:, L.u[0]] * unorm


def extract_trajectory_soft(x, veh: VehicleParams, G, g, q_curr, u_curr):
    """Full (q, u) solutions (B, N, 6), (B, N, 2) for warm-start
    resampling: states through the rollout map, knot 0 the pinned current
    state and control."""
    unorm = torch.as_tensor(u_normalization(veh), dtype=x.dtype,
                            device=x.device)
    q_tail = torch.einsum("btij,bj->bti", G, x) + g
    q_sol = torch.cat([q_curr[:, None], q_tail], dim=1)
    u_sol = torch.cat([u_curr[:, None],
                       x.reshape(x.shape[0], -1, 2) * unorm], dim=1)
    return q_sol, u_sol
