"""MPC orchestration of the port: the two-timescale time grid,
linearization-node seeding (cold trim rollout and warm resampling), and
the batched control step `mpc_step_batched`.

Counterpart of the coupled soft path of `pigeon_tpu/mpc.py`: path
projection, node seeding, HJI constraint, exact linearization and soft
condensed QP assembly, the lane ADMM solve, control extraction, clamping
and NaN fallback for a fleet of B vehicles.  Every tensor carries a
leading batch dimension where the JAX package used `vmap`, and each
`lax.scan` over stages is a Python loop.  The step makes no host sync
when the solver runs one segment (max_iter == check_every).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.config import (CoupledControlParams,
                                     DecoupledControlParams, HorizonParams,
                                     SolverOptions, VehicleParams, x1_params)
from pigeon_tpu_torch.math_utils import adiff
from pigeon_tpu_torch.qp import condensed as qp_condensed
from pigeon_tpu_torch.qp.coupled import CoupledStageData, u_normalization
from pigeon_tpu_torch.solver.admm import QPData, QPSolution, QPWarmStart
from pigeon_tpu_torch.solver.lane_admm import solve_lanes_batched


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static controller configuration, the same fields as
    `pigeon_tpu.mpc.MPCConfig`.  The port runs the coupled soft condensed
    formulation on the lane solver (`solver.backend` is not read);
    `_check_supported` rejects the options it has not ported."""

    veh: VehicleParams
    hz: HorizonParams
    coupled: CoupledControlParams = CoupledControlParams()
    decoupled: DecoupledControlParams = DecoupledControlParams()
    solver: SolverOptions = SolverOptions()
    formulation: str = "coupled"
    condensed: bool = False
    soft: bool = False
    timed_mode: bool = False              # reference tracking_mode :traj
    hji_eps: float = 0.05                 # reference HJI_eps
    use_hji_policy: bool = False          # "hammer" override
    sim_substeps: int = 1
    warm_nodes: bool = True               # resample prev solution as nodes
    tire_inverse: str = "corrected"       # see dynamics._inv_fiala
    lin_method: str = "expm"
    lin_substeps: int = 1
    clamp_commands: bool = True           # clamp the published command
    hji_row_normalize: bool = True        # unit-normalize the HJI row


def x1_coupled_config(**kw) -> MPCConfig:
    """The live coupled singleton: N_short=5, N_long=10."""
    hz = kw.pop("hz", HorizonParams(N_short=5, N_long=10))
    return MPCConfig(veh=x1_params(), hz=hz, formulation="coupled", **kw)


def _check_supported(cfg: MPCConfig):
    unsupported = []
    if cfg.formulation != "coupled" or not cfg.soft:
        unsupported.append("only the coupled soft formulation is ported")
    if cfg.lin_method != "expm":
        unsupported.append("only lin_method='expm' is ported")
    if cfg.lin_substeps != 1:
        unsupported.append("lin_substeps (the rk4 linearization's substeps) "
                           "is not ported")
    if cfg.sim_substeps != 1:
        unsupported.append("sim_substeps (the plant of `simulate`) is not "
                           "ported")
    if cfg.use_hji_policy:
        unsupported.append("the HJI override (use_hji_policy) is not ported")
    if cfg.coupled.use_walls:
        unsupported.append("wall rows (use_walls) are not ported")
    if unsupported:
        raise NotImplementedError("; ".join(unsupported))


# ---------------------------------------------------------------------------
# Time grid (reference compute_time_steps!)
# ---------------------------------------------------------------------------

def compute_time_steps(hz: HorizonParams, t):
    """t (B,) -> knot times ts (B, N) and steps dt (B, T)."""
    S, Lg = hz.N_short, hz.N_long
    dts, dtl = hz.dt_short, hz.dt_long
    ar = lambda lo, hi: torch.arange(lo, hi, dtype=t.dtype, device=t.device)
    ts_short = t[:, None] + dts * ar(0, S + 1)
    t0_long = t + S * dts
    if hz.use_correction_step:
        t0_long = dtl * torch.ceil((t0_long + dts) / dtl - 1.0)
    ts_long = t0_long[:, None] + dtl * ar(1, Lg + 1)
    ts = torch.cat([ts_short, ts_long], dim=-1)
    return ts, torch.diff(ts, dim=-1)


# ---------------------------------------------------------------------------
# Carry state
# ---------------------------------------------------------------------------

class MPCCarry(NamedTuple):
    """Controller state threaded between steps, batched over vehicles."""

    prev_ts: torch.Tensor         # (B, N)
    q_prev: torch.Tensor          # (B, N, 6) previous solution states
    u_prev: torch.Tensor          # (B, N, 2) previous solution controls
    solved: torch.Tensor          # (B,) bool: warm data valid
    warm_x: torch.Tensor          # (B, n) ADMM warm start
    warm_y: torch.Tensor          # (B, m)
    warm_z: torch.Tensor          # (B, m)
    current_control: torch.Tensor  # (B, 3) last command (delta, Fxf, Fxr)
    nan_fallback: torch.Tensor    # (B,) bool: previous step fell back
    warm_rho: torch.Tensor        # (B,) adapted ADMM rho multiplier


class StepDiagnostics(NamedTuple):
    s: torch.Tensor
    e: torch.Tensor
    V_hji: torch.Tensor
    hji_active: torch.Tensor
    iterations: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    converged: torch.Tensor
    solution_finite: torch.Tensor


def init_carry(cfg: MPCConfig, batch: int, dtype=torch.float32,
               device=None) -> MPCCarry:
    """A cold carry for `batch` vehicles on `device` (None: the card)."""
    _check_supported(cfg)
    device = resolve_device(device)
    N = cfg.hz.N
    L = qp_condensed.get_soft_layout(cfg.hz, cfg.coupled.use_walls)
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype,
                                   device=device)
    no = torch.zeros((batch,), dtype=torch.bool, device=device)
    return MPCCarry(
        prev_ts=torch.arange(1, N + 1, dtype=dtype, device=device)
        .expand(batch, N).clone(),
        q_prev=z(N, 6), u_prev=z(N, 2), solved=no,
        warm_x=z(L.n), warm_y=z(L.m), warm_z=z(L.m),
        current_control=z(3), nan_fallback=no.clone(),
        warm_rho=torch.ones((batch,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Linearization nodes (reference src/coupled_lat_long.jl:62-142)
# ---------------------------------------------------------------------------

def _accel_desired(cfg, tj_A, tj_V, V, ds_i, tau):
    """Feedforward accel law."""
    ctl = cfg.coupled
    A = tj_A + ctl.k_V * (tj_V - V) / tau
    if cfg.timed_mode:
        A = A - ctl.k_s * ds_i / (tau * tau)
    return torch.clamp(A, (ctl.V_min - V) / tau, (ctl.V_max - V) / tau)


def _nodes_coupled_cold(cfg: MPCConfig, tube, q0, u0, ts, dt, s0, e0):
    """Trim-rollout nodes: stage 0 from the measured state, short stages
    with the 1-iteration warm-state trim, long stages with the
    4-iteration cold trim.  (s0, e0) is the projection of q0."""
    veh, hz = cfg.veh, cfg.hz
    S, N = hz.N_short, hz.N
    tj0 = trj.eval_arclength(tube, s0, fields=("psi", "kappa"))
    dpsi0 = adiff(q0[:, 2], tj0.psi)
    u20 = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)

    sD, cD = torch.sin(dpsi0), torch.cos(dpsi0)
    V0 = q0[:, 3] * cD - q0[:, 4] * sD
    beta0 = torch.atan2(q0[:, 4], q0[:, 3])
    r0, delta0 = q0[:, 5], u0[:, 0]
    Fyf0, _ = dyn.lateral_tire_forces(veh, q0[:, 3], q0[:, 4], q0[:, 5], u0)

    ds0 = s0 - trj.eval_time(tube, ts[:, 0], fields=()).s
    q_0 = torch.stack([ds0, q0[:, 3], q0[:, 4], q0[:, 5], dpsi0, e0], dim=-1)
    p_0 = torch.stack([tj0.V, tj0.kappa, 0.0 * s0, 0.0 * s0], dim=-1)
    qdot = dyn.vehicle_ode(veh, "bicycle", q0, u20, torch.zeros_like(q0[:, :4]))
    A_0 = ((qdot[:, 3] - q0[:, 5] * q0[:, 4]) * cD
           - (qdot[:, 4] + q0[:, 5] * q0[:, 3]) * sD)

    tau0 = dt[:, 0]
    V = V0 + A_0 * tau0
    s = s0 + V * tau0 + A_0 * tau0 * tau0 / 2.0
    taus = torch.cat([dt[:, 1:], dt[:, N - 2:N - 1]], dim=-1)
    cti = cfg.tire_inverse == "corrected"

    qs, us, ps = [q_0], [u20], [p_0]
    for i in range(N - 1):
        tau, t_i = taus[:, i], ts[:, i + 1]
        tj = trj.eval_arclength(tube, s, fields=("psi", "kappa"))
        ds_i = s - trj.eval_time(tube, t_i, fields=()).s
        A_des = _accel_desired(cfg, tj.A, tj.V, V, ds_i, tau)
        if i < S:
            est = dyn.steady_state_estimates(
                veh, V, A_des, tj.kappa, num_iters=1, r=r0, beta0=beta0,
                delta0=delta0, Fyf0=Fyf0, corrected_tire_inverse=cti)
            q = torch.stack([ds_i, q0[:, 3], q0[:, 4], q0[:, 5],
                             adiff(q0[:, 2], tj.psi), e0], dim=-1)
        else:
            est = dyn.steady_state_estimates(
                veh, V, A_des, tj.kappa, num_iters=4,
                corrected_tire_inverse=cti)
            q = torch.stack([ds_i, est.Ux, est.Uy, est.r, -est.beta,
                             0.0 * s], dim=-1)
        qs.append(q)
        us.append(torch.stack([est.delta, est.Fxf + est.Fxr], dim=-1))
        ps.append(torch.stack([tj.V, tj.kappa, 0.0 * s, 0.0 * s], dim=-1))
        V = V + est.A * tau
        s = s + V * tau + est.A * tau * tau / 2.0
    return (torch.stack(qs, dim=1), torch.stack(us, dim=1),
            torch.stack(ps, dim=1))


def _nodes_coupled_warm(cfg: MPCConfig, tube, q0, u0, ts, carry: MPCCarry,
                        s0, e0):
    """Resample the previous solution onto the new grid (one interpolation-
    weight matmul per instance)."""
    tj0 = trj.eval_arclength(tube, s0, fields=("psi", "kappa"))
    ds0 = s0 - trj.eval_time(tube, ts[:, 0], fields=()).s
    q_node0 = torch.stack([ds0, q0[:, 3], q0[:, 4], q0[:, 5],
                           adiff(q0[:, 2], tj0.psi), e0], dim=-1)
    u_node0 = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)
    p_node0 = torch.stack([tj0.V, tj0.kappa, 0.0 * s0, 0.0 * s0], dim=-1)

    prev_ts = carry.prev_ts
    tq = torch.clamp(ts[:, 1:], prev_ts[:, 0:1], prev_ts[:, -1:])
    Y = torch.cat([carry.q_prev, carry.u_prev], dim=-1)       # (B, K, 8)
    nxq = carry.q_prev.shape[-1]
    K = prev_ts.shape[-1]
    j = torch.clamp(torch.sum(tq[..., None] >= prev_ts[:, None, :], dim=-1)
                    - 1, 0, K - 2)
    kk = torch.arange(K, device=ts.device)
    oh_j = (kk == j[..., None]).to(Y.dtype)                   # (B, T, K)
    oh_j1 = (kk == (j + 1)[..., None]).to(Y.dtype)
    ts_j = (oh_j @ prev_ts[..., None])[..., 0]
    ts_j1 = (oh_j1 @ prev_ts[..., None])[..., 0]
    lam = torch.clamp((tq - ts_j) / torch.clamp(ts_j1 - ts_j, min=1e-9),
                      0.0, 1.0)
    W = (1.0 - lam)[..., None] * oh_j + lam[..., None] * oh_j1
    vals = W @ Y
    q_tail, u_tail = vals[..., :nxq], vals[..., nxq:]
    s_tail = trj.eval_time(tube, ts[:, 1:], fields=()).s + q_tail[..., 0]
    tj = trj.eval_arclength(tube, s_tail, fields=("kappa",))
    zero = torch.zeros_like(tj.V)
    p_tail = torch.stack([tj.V, tj.kappa, zero, zero], dim=-1)
    return (torch.cat([q_node0[:, None], q_tail], dim=1),
            torch.cat([u_node0[:, None], u_tail], dim=1),
            torch.cat([p_node0[:, None], p_tail], dim=1))


# ---------------------------------------------------------------------------
# The MPC step
# ---------------------------------------------------------------------------

class _PreAux(NamedTuple):
    """Pre-solve values the post-solve phase needs."""

    ts: torch.Tensor
    s0: torch.Tensor
    e0: torch.Tensor
    V_hji: torch.Tensor
    us: torch.Tensor
    G: torch.Tensor
    g: torch.Tensor
    w: torch.Tensor
    q0_node: torch.Tensor


def _pre_solve(cfg: MPCConfig, tube, cache, carry: MPCCarry, q0, u0,
               other_car, t):
    """Projection, node seeding, HJI constraint, linearization and QP
    assembly.  Both node sets are computed and selected per vehicle by
    `carry.solved` (the JAX package's "auto" branch; equal to its
    warm-only branch when every carry is warm), so no host sync."""
    veh, hz = cfg.veh, cfg.hz
    ts, dt = compute_time_steps(hz, t)
    s0, e0, _ = trj.path_coordinates(tube, q0[:, :2])

    cold = _nodes_coupled_cold(cfg, tube, q0, u0, ts, dt, s0, e0)
    if cfg.warm_nodes:
        warm = _nodes_coupled_warm(cfg, tube, q0, u0, ts, carry, s0, e0)
        sel = carry.solved[:, None, None]
        qs, us, ps = (torch.where(sel, w, c) for c, w in zip(cold, warm))
    else:
        qs, us, ps = cold

    u_lin = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)
    x_rel = hji_mod.relative_state(q0, other_car)
    Bn = q0.shape[0]
    if cfg.coupled.use_hji:
        M, b, V_hji, _ = hji_mod.reachability_constraint(
            veh, cache, x_rel, cfg.hji_eps, u_lin)
        if cfg.hji_row_normalize:
            # unit-normalize in the normalized-u metric and clamp the bound
            # to the achievable set (see pigeon_tpu.mpc.MPCConfig)
            unorm = torch.as_tensor(u_normalization(veh), dtype=q0.dtype,
                                    device=q0.device)
            Mn = M * unorm
            nrm = torch.sqrt(torch.sum(Mn * Mn, dim=-1))
            live = nrm > 1e-9
            scale = torch.where(live, 1.0 / torch.clamp(nrm, min=1e-9),
                                torch.ones_like(nrm))
            M = M * scale[:, None]
            b = b * scale
            l1 = torch.sum(torch.abs(Mn), dim=-1) * scale
            b = torch.where(live, torch.maximum(b, -0.95 * l1), b)
    else:
        M = torch.zeros_like(q0[:, :2])
        b = torch.ones_like(q0[:, 0])
        V_hji = torch.full((Bn,), torch.inf, dtype=q0.dtype,
                           device=q0.device)

    data = CoupledStageData(dt=dt, qs=qs, us=us, ps=ps, hji_M=M, hji_b=b)
    sqp = qp_condensed.build_qp_soft(veh, cfg.coupled, hz, data)
    qp = QPData(sqp.P, sqp.q, sqp.A, sqp.l, sqp.u)
    solved = carry.solved
    warm_start = QPWarmStart(
        x=torch.where(solved[:, None], carry.warm_x, 0.0),
        y=torch.where(solved[:, None], carry.warm_y, 0.0),
        z=torch.where(solved[:, None], carry.warm_z, 0.0),
        rho_scale=torch.where(solved, carry.warm_rho, 1.0))
    aux = _PreAux(ts=ts, s0=s0, e0=e0, V_hji=V_hji, us=us, G=sqp.G,
                  g=sqp.g, w=sqp.w, q0_node=qs[:, 0])
    return qp, warm_start, aux


def _post_solve(cfg: MPCConfig, carry: MPCCarry, q0, sol: QPSolution,
                aux: _PreAux):
    """Control extraction, clamping, NaN fallback and carry update."""
    veh, hz = cfg.veh, cfg.hz
    u2 = qp_condensed.extract_control_soft(veh, hz, sol.x)
    q_sol, u_sol = qp_condensed.extract_trajectory_soft(
        sol.x, veh, aux.G, aux.g, aux.q0_node, aux.us[:, 0])
    if cfg.clamp_commands:
        u2 = dyn.apply_control_limits(veh, u2, q0[:, 3])
    Fxf, Fxr = dyn.longitudinal_split(veh, u2[:, 1])
    u3 = torch.stack([u2[:, 0], Fxf, Fxr], dim=-1)

    finite = torch.all(torch.isfinite(u3), dim=-1)
    fallback = torch.where(carry.nan_fallback[:, None],
                           torch.zeros_like(u3), carry.current_control)
    u3_out = torch.where(finite[:, None], u3, fallback)
    hji_active = aux.V_hji <= cfg.hji_eps

    f1, f2 = finite[:, None], finite[:, None, None]
    new_carry = MPCCarry(
        prev_ts=aux.ts,
        q_prev=torch.where(f2, q_sol, carry.q_prev),
        u_prev=torch.where(f2, u_sol, carry.u_prev),
        solved=finite,
        warm_x=torch.where(f1, sol.x, 0.0),
        warm_y=torch.where(f1, sol.y, 0.0),
        warm_z=torch.where(f1, sol.z, 0.0),
        current_control=u3_out,
        nan_fallback=~finite,
        warm_rho=torch.where(finite, sol.rho_scale, 1.0),
    )
    diag = StepDiagnostics(
        s=aux.s0, e=aux.e0, V_hji=aux.V_hji, hji_active=hji_active,
        iterations=sol.iterations, prim_res=sol.prim_res,
        dual_res=sol.dual_res, converged=sol.converged,
        solution_finite=finite)
    return new_carry, u3_out, diag


def mpc_step_batched(cfg: MPCConfig, tube: trj.TrajectoryTube,
                     cache: hji_mod.HJICache, carries: MPCCarry, q0s, u0s,
                     other_cars, ts):
    """One control step for a fleet: q0s (B, 6) bicycle states, u0s (B, 3)
    commands in effect, other_cars (B, 4) simple-car states, ts (B,)
    times.  Returns (new carries, commands (B, 3), diagnostics)."""
    _check_supported(cfg)
    qp, warm, aux = _pre_solve(cfg, tube, cache, carries, q0s, u0s,
                               other_cars, ts)
    sol = solve_lanes_batched(qp, warm, cfg.solver, w_soft=aux.w)
    return _post_solve(cfg, carries, q0s, sol, aux)
