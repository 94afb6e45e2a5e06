"""MPC orchestration of the port: the two-timescale time grid,
linearization-node seeding (cold trim rollout and warm resampling), the
batched control step `mpc_step_batched`, the single-vehicle `mpc_step`
and the closed-loop `simulate`.

Counterpart of `pigeon_tpu/mpc.py` for the soft condensed formulations,
coupled and decoupled, the two hard-constraint coupled formulations,
sparse and condensed, and the sparse decoupled one: path projection, node
seeding, HJI constraint, exact linearization and QP assembly, the ADMM
solve, control extraction, clamping, NaN fallback and the HJI override.
Every tensor carries a leading batch dimension where the JAX package used
`vmap`, and each `lax.scan` over stages is a Python loop.

Two routes, as in the JAX package.  `mpc_step_batched` (a fleet)
linearizes through the structured Van Loan kernel and solves with
`solve_qp_batched`; on the "lanes" backend with one segment
(max_iter == check_every) the step makes no host sync, on the "pallas"
backend (the hard QPs) one per solver segment but the last.  `mpc_step`
(one vehicle) linearizes through the dense stage matrix on the dense
expm kernel and solves with the single-instance `solve_qp` (on the
"pallas" backend one dense ADMM kernel launch per segment).  The sparse
decoupled QP linearizes each stage on the dense expm kernel on both
routes, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.config import (CoupledControlParams,
                                     DecoupledControlParams, HorizonParams,
                                     SolverOptions, VehicleParams, x1_params)
from pigeon_tpu_torch.math_utils import adiff
from pigeon_tpu_torch.qp import condensed as qp_condensed
from pigeon_tpu_torch.qp import coupled as qp_coupled
from pigeon_tpu_torch.qp import decoupled as qp_decoupled
from pigeon_tpu_torch.qp.coupled import CoupledStageData, u_normalization
from pigeon_tpu_torch.solver.admm import (QPData, QPSolution, QPWarmStart,
                                          solve_qp, solve_qp_batched)


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static controller configuration, the same fields as
    `pigeon_tpu.mpc.MPCConfig`.  The port runs the soft condensed
    formulations, coupled and decoupled, the sparse ones (`soft=False`,
    the JAX package's default: coupled with `condensed=False`, and
    decoupled) and the hard condensed coupled one (`soft=False,
    condensed=True`), each coupled one with or without the wall rows
    (`coupled.use_walls`) and on lin_method "expm", "expm_split" or "rk4"
    with `lin_substeps` (the decoupled QPs read neither, as in the JAX
    package); `_check_supported` rejects an unknown formulation."""

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


def x1_decoupled_config(**kw) -> MPCConfig:
    """The decoupled singleton: N_short=10, N_long=20."""
    hz = kw.pop("hz", HorizonParams(N_short=10, N_long=20))
    return MPCConfig(veh=x1_params(), hz=hz, formulation="decoupled", **kw)


def _check_supported(cfg: MPCConfig):
    if cfg.formulation not in ("coupled", "decoupled"):
        raise NotImplementedError(
            f"unknown formulation {cfg.formulation!r}")


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
    """Controller state threaded between steps, batched over vehicles
    (`mpc_step` takes and returns it without the leading dimension)."""

    prev_ts: torch.Tensor         # (B, N)
    q_prev: torch.Tensor          # (B, N, nx) previous solution states
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


def _hard(cfg: MPCConfig) -> bool:
    """A hard-constraint coupled QP, sparse or condensed."""
    return cfg.formulation == "coupled" and not cfg.soft


def _sparse(cfg: MPCConfig) -> bool:
    """The sparse (hard-constraint) coupled QP."""
    return _hard(cfg) and not cfg.condensed


def _sparse_decoupled(cfg: MPCConfig) -> bool:
    """The sparse (hard-constraint) decoupled QP."""
    return cfg.formulation == "decoupled" and not cfg.soft


def _layout(cfg: MPCConfig):
    if _sparse_decoupled(cfg):
        return qp_decoupled.get_layout(cfg.hz)
    if _sparse(cfg):
        return qp_coupled.get_layout(cfg.hz, cfg.coupled.use_walls)
    if _hard(cfg):
        return qp_condensed.get_layout(cfg.hz, cfg.coupled.use_walls)
    if cfg.formulation == "coupled":
        return qp_condensed.get_soft_layout(cfg.hz, cfg.coupled.use_walls)
    return qp_decoupled.get_soft_layout(cfg.hz)


def _banded_plan_for(cfg: MPCConfig):
    """The stage plan of the banded factor, for the sparse coupled QP (the
    condensed QP's dense P has no banded form: its factor falls through
    to "chol")."""
    if (cfg.solver.factor_method in ("banded", "banded_cr")
            and _sparse(cfg)):
        from pigeon_tpu_torch.solver.banded import coupled_stage_plan
        return coupled_stage_plan(cfg.hz, cfg.coupled.use_walls)
    return None


def _a_pattern_for(cfg: MPCConfig):
    """A hard QP's static nonzero pattern of A, for the "pallas"
    pipeline's dense ADMM kernel."""
    if cfg.solver.backend == "pallas" and (_hard(cfg)
                                           or _sparse_decoupled(cfg)):
        from pigeon_tpu_torch.solver.pallas_admm import layout_pattern
        return layout_pattern(_layout(cfg).lay)
    return None


def _eq_rows_for(cfg: MPCConfig):
    """The statically known equality rows of a hard coupled QP (none for
    the sparse decoupled QP, as in the JAX package: its rows with l == u
    get the stiff rho at run time, and the mixed modes raise there)."""
    return _layout(cfg).eq_rows if _hard(cfg) else None


def init_carry(cfg: MPCConfig, batch: "int | None", dtype=torch.float32,
               device=None) -> MPCCarry:
    """A cold carry for `batch` vehicles on `device` (None: the card);
    `batch=None` gives the carry of one vehicle without the leading
    dimension, as `mpc_step` takes it."""
    _check_supported(cfg)
    device = resolve_device(device)
    if batch is None:
        return MPCCarry(*[x[0] for x in init_carry(cfg, 1, dtype, device)])
    N = cfg.hz.N
    nx = 6 if cfg.formulation == "coupled" else 4
    L = _layout(cfg)
    z = lambda *shape: torch.zeros((batch,) + shape, dtype=dtype,
                                   device=device)
    no = torch.zeros((batch,), dtype=torch.bool, device=device)
    return MPCCarry(
        prev_ts=torch.arange(1, N + 1, dtype=dtype, device=device)
        .expand(batch, N).clone(),
        q_prev=z(N, nx), u_prev=z(N, 2), solved=no,
        warm_x=z(L.n), warm_y=z(L.m), warm_z=z(L.m),
        current_control=z(3), nan_fallback=no.clone(),
        warm_rho=torch.ones((batch,), dtype=dtype, device=device))


# ---------------------------------------------------------------------------
# Linearization nodes (reference src/coupled_lat_long.jl:62-142)
# ---------------------------------------------------------------------------

def _accel_desired(cfg, tj_A, tj_V, V, ds_i, tau):
    """Feedforward accel law, with the formulation's own gains."""
    ctl = cfg.coupled if cfg.formulation == "coupled" else cfg.decoupled
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
# Linearization nodes, decoupled (reference src/decoupled_lat_long.jl:52-104;
# always trim-seeded: the reference decoupled MPC has no warm branch)
# ---------------------------------------------------------------------------

def _nodes_decoupled(cfg: MPCConfig, tube, q0, u0, ts, dt, s0, e0):
    """Lateral nodes (Uy, r, dpsi, e) with parameters (Ux, kappa, 0, 0):
    stage 0 from the measured state, short stages holding the measured
    (Uy, r, e) with the 1-iteration warm-state trim's controls, long
    stages at the 4-iteration cold trim.  (s0, e0) is the projection of
    q0."""
    veh, hz = cfg.veh, cfg.hz
    S, N = hz.N_short, hz.N
    V0 = torch.hypot(q0[:, 3], q0[:, 4])
    beta0 = torch.atan2(q0[:, 4], q0[:, 3])
    r0, delta0 = q0[:, 5], u0[:, 0]
    Fyf0, _ = dyn.lateral_tire_forces(veh, q0[:, 3], q0[:, 4], q0[:, 5], u0)
    u20 = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)

    tj0 = trj.eval_arclength(tube, s0, fields=("psi", "kappa"))
    q_0 = torch.stack([q0[:, 4], q0[:, 5], adiff(q0[:, 2], tj0.psi), e0],
                      dim=-1)
    p_0 = torch.stack([q0[:, 3], tj0.kappa, 0.0 * s0, 0.0 * s0], dim=-1)
    qdot = dyn.vehicle_ode(veh, "bicycle", q0, u20, torch.zeros_like(q0[:, :4]))
    A_0 = ((qdot[:, 3] - q0[:, 5] * q0[:, 4]) * torch.cos(beta0)
           + (qdot[:, 4] + q0[:, 5] * q0[:, 3]) * torch.sin(beta0))

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
            q = torch.stack([q0[:, 4], q0[:, 5], adiff(q0[:, 2], tj.psi),
                             e0], dim=-1)
        else:
            est = dyn.steady_state_estimates(
                veh, V, A_des, tj.kappa, num_iters=4,
                corrected_tire_inverse=cti)
            q = torch.stack([est.Uy, est.r, -est.beta, 0.0 * s], dim=-1)
        qs.append(q)
        us.append(torch.stack([est.delta, est.Fxf + est.Fxr], dim=-1))
        ps.append(torch.stack([est.Ux, tj.kappa, 0.0 * s, 0.0 * s], dim=-1))
        V = V + est.A * tau
        s = s + V * tau + est.A * tau * tau / 2.0
    return (torch.stack(qs, dim=1), torch.stack(us, dim=1),
            torch.stack(ps, dim=1))


# ---------------------------------------------------------------------------
# The MPC step
# ---------------------------------------------------------------------------

class _PreAux(NamedTuple):
    """Pre-solve values the post-solve phase needs."""

    ts: torch.Tensor
    s0: torch.Tensor
    e0: torch.Tensor
    V_hji: torch.Tensor
    gradV: torch.Tensor    # (B, 7) the value gradient at x_rel
    x_rel: torch.Tensor    # (B, 7) the HJI relative state
    us: torch.Tensor
    q0_node: torch.Tensor
    G: "torch.Tensor | None" = None   # condensed: the rollout map
    g: "torch.Tensor | None" = None
    w: "torch.Tensor | None" = None   # soft: per-row penalty weights


def _pre_solve(cfg: MPCConfig, tube, cache, carry: MPCCarry, q0, u0,
               other_car, t, unbatched: bool = False,
               nodes_mode: str = "auto"):
    """Projection, node seeding, HJI constraint, linearization and QP
    assembly.  Coupled: both node sets are computed and selected per
    vehicle by `carry.solved` (the JAX package's "auto" branch; equal to
    its warm-only branch when every carry is warm), so no host sync;
    `nodes_mode="warm_only"` computes only the warm nodes, whatever
    `carry.solved` says.  With wall rows the edges are read at each
    node's arclength, the path's s at the node time plus the node's ds.
    Decoupled: always the trim-seeded nodes, no HJI row; the soft QP
    or, with `cfg.soft` False, the sparse one.  The coupled QP is the
    soft condensed one or, with `cfg.soft` False, the sparse one
    (`qp/coupled.py`) or with `cfg.condensed` the hard condensed one
    (`qp/condensed.py`).  `unbatched` (set by `mpc_step`) takes the
    single-vehicle route of the assembly: dense linearization, sequential
    rollout."""
    veh, hz = cfg.veh, cfg.hz
    ts, dt = compute_time_steps(hz, t)
    s0, e0, _ = trj.path_coordinates(tube, q0[:, :2])
    Bn = q0.shape[0]
    x_rel = hji_mod.relative_state(q0, other_car)
    # (V, gradV) where no HJI row is built
    no_hji = (torch.full((Bn,), torch.inf, dtype=q0.dtype,
                         device=q0.device), torch.zeros_like(x_rel))

    if cfg.formulation == "decoupled":
        qs, us, ps = _nodes_decoupled(cfg, tube, q0, u0, ts, dt, s0, e0)
        data = qp_decoupled.DecoupledStageData(dt=dt, qs=qs, us=us, ps=ps)
        if not cfg.soft:
            qp = qp_decoupled.build_qp(veh, cfg.decoupled, hz, data)
            return _pack_pre(carry, qp, ts, s0, e0, *no_hji, x_rel, us, qs)
        sqp = qp_decoupled.build_qp_soft(veh, cfg.decoupled, hz, data,
                                         unbatched=unbatched)
        return _pack_pre(carry, QPData(*sqp[:5]), ts, s0, e0, *no_hji,
                         x_rel, us, qs, G=sqp.G, g=sqp.g, w=sqp.w)

    if nodes_mode == "warm_only" and cfg.warm_nodes:
        qs, us, ps = _nodes_coupled_warm(cfg, tube, q0, u0, ts, carry, s0,
                                         e0)
    elif cfg.warm_nodes:
        cold = _nodes_coupled_cold(cfg, tube, q0, u0, ts, dt, s0, e0)
        warm = _nodes_coupled_warm(cfg, tube, q0, u0, ts, carry, s0, e0)
        sel = carry.solved[:, None, None]
        qs, us, ps = (torch.where(sel, w, c) for c, w in zip(cold, warm))
    else:
        qs, us, ps = _nodes_coupled_cold(cfg, tube, q0, u0, ts, dt, s0, e0)

    u_lin = torch.stack([u0[:, 0], u0[:, 1] + u0[:, 2]], dim=-1)
    if cfg.coupled.use_hji:
        M, b, V_hji, gradV = hji_mod.reachability_constraint(
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
        V_hji, gradV = no_hji

    edges = None
    if cfg.coupled.use_walls:
        s_nodes = trj.eval_time(tube, ts, fields=()).s + qs[..., 0]
        tj = trj.eval_arclength(tube, s_nodes, fields=("edge_L", "edge_R"))
        edges = torch.stack([tj.edge_L, tj.edge_R], dim=-1)
    data = CoupledStageData(dt=dt, qs=qs, us=us, ps=ps, hji_M=M, hji_b=b,
                            edges=edges)
    qp, G, g, w = _assemble_coupled(cfg, data, unbatched)
    return _pack_pre(carry, qp, ts, s0, e0, V_hji, gradV, x_rel, us, qs,
                     G, g, w)


def _assemble_coupled(cfg: MPCConfig, data: CoupledStageData,
                      unbatched: bool = False):
    """Linearization and assembly of the coupled QP that `cfg` solves,
    the sparse, the hard condensed or the soft condensed one: (QPData,
    G, g, w), the rollout map (G, g) of a condensed QP and the penalty
    weights w of a soft one, None where the QP has none."""
    veh, hz = cfg.veh, cfg.hz
    lin = dict(lin_method=cfg.lin_method, lin_substeps=cfg.lin_substeps,
               unbatched=unbatched)
    if _sparse(cfg):
        return (qp_coupled.build_qp(veh, cfg.coupled, hz, data, **lin),
                None, None, None)
    if _hard(cfg):
        cqp = qp_condensed.build_qp(veh, cfg.coupled, hz, data, **lin)
        return QPData(*cqp[:5]), cqp.G, cqp.g, None
    sqp = qp_condensed.build_qp_soft(veh, cfg.coupled, hz, data, **lin)
    return QPData(*sqp[:5]), sqp.G, sqp.g, sqp.w


def _pack_pre(carry: MPCCarry, qp: QPData, ts, s0, e0, V_hji, gradV, x_rel,
              us, qs, G=None, g=None, w=None):
    """The solver's inputs from an assembled QP, with the rollout map (G,
    g) of a condensed QP and the penalty weights `w` of a soft one:
    (QPData, warm start masked by `carry.solved`, _PreAux)."""
    solved = carry.solved
    warm_start = QPWarmStart(
        x=torch.where(solved[:, None], carry.warm_x, 0.0),
        y=torch.where(solved[:, None], carry.warm_y, 0.0),
        z=torch.where(solved[:, None], carry.warm_z, 0.0),
        rho_scale=torch.where(solved, carry.warm_rho, 1.0))
    aux = _PreAux(ts=ts, s0=s0, e0=e0, V_hji=V_hji, gradV=gradV,
                  x_rel=x_rel, us=us, q0_node=qs[:, 0], G=G, g=g, w=w)
    return qp, warm_start, aux


def _post_solve(cfg: MPCConfig, carry: MPCCarry, q0, sol: QPSolution,
                aux: _PreAux):
    """Control extraction, clamping, NaN fallback, the HJI override and
    the carry update."""
    veh, hz = cfg.veh, cfg.hz
    walls = cfg.formulation == "coupled" and cfg.coupled.use_walls
    if _sparse(cfg):
        u2 = qp_coupled.extract_control(veh, hz, sol.x, walls)
        q_sol, u_sol = qp_coupled.extract_trajectory(hz, sol.x, veh, walls)
    elif _hard(cfg):
        u2 = qp_condensed.extract_control(veh, hz, sol.x, walls)
        q_sol, u_sol = qp_condensed.extract_trajectory(hz, sol.x, veh, aux.G,
                                                       aux.g, walls)
    elif _sparse_decoupled(cfg):
        u2 = qp_decoupled.extract_control(hz, sol.x, aux.us)
        q_sol, u_sol = qp_decoupled.extract_trajectory(hz, sol.x, aux.us)
    elif cfg.formulation == "coupled":
        u2 = qp_condensed.extract_control_soft(veh, hz, sol.x, walls)
        q_sol, u_sol = qp_condensed.extract_trajectory_soft(
            sol.x, veh, aux.G, aux.g, aux.q0_node, aux.us[:, 0])
    else:
        u2 = qp_decoupled.extract_control_soft(hz, sol.x, aux.us)
        q_sol, u_sol = qp_decoupled.extract_trajectory_soft(
            hz, sol.x, aux.G, aux.g, aux.q0_node, aux.us)
    if cfg.clamp_commands:
        u2 = dyn.apply_control_limits(veh, u2, q0[:, 3])
    Fxf, Fxr = dyn.longitudinal_split(veh, u2[:, 1])
    u3 = torch.stack([u2[:, 0], Fxf, Fxr], dim=-1)

    finite = torch.all(torch.isfinite(u3), dim=-1)
    fallback = torch.where(carry.nan_fallback[:, None],
                           torch.zeros_like(u3), carry.current_control)
    u3_out = torch.where(finite[:, None], u3, fallback)
    hji_active = aux.V_hji <= cfg.hji_eps
    overridden = torch.zeros_like(hji_active)
    if cfg.formulation == "coupled" and cfg.use_hji_policy:
        # the "hammer": where V <= eps the published command is the HJI
        # optimal control, and the carry is marked unsolved so that the
        # next step seeds cold nodes and a cold solver start
        u2_opt = hji_mod.optimal_control(veh, aux.x_rel, aux.gradV)
        Fxf_o, Fxr_o = dyn.longitudinal_split(veh, u2_opt[:, 1])
        u3_opt = torch.stack([u2_opt[:, 0], Fxf_o, Fxr_o], dim=-1)
        u3_out = torch.where(hji_active[:, None], u3_opt, u3_out)
        overridden = hji_active

    f1, f2 = finite[:, None], finite[:, None, None]
    new_carry = MPCCarry(
        prev_ts=aux.ts,
        q_prev=torch.where(f2, q_sol, carry.q_prev),
        u_prev=torch.where(f2, u_sol, carry.u_prev),
        solved=finite & ~overridden,
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
    times.  Returns (new carries, commands (B, 3), diagnostics).

    The solver is `cfg.solver.backend`'s, as in the JAX package.  The
    default, "xla", is the plain PyTorch ADMM on whatever device the
    tensors lie.  The soft QPs' solver kernels (`chol_inverse`,
    `admm_iterations`) run under backend="lanes"; the hard QPs' (`ruiz`,
    `admm_dense`) under backend="pallas", with the sparse QP's
    `banded_chol` factor under factor_method="banded" (also with "xla";
    the condensed QP's dense P falls through to "chol").
    A caller sets them with `dataclasses.replace(cfg,
    solver=SolverOptions(backend=..., ...))`.  The linearization and
    rollout kernels run under any backend."""
    _check_supported(cfg)
    qp, warm, aux = _pre_solve(cfg, tube, cache, carries, q0s, u0s,
                               other_cars, ts)
    sol = solve_qp_batched(qp, warm, cfg.solver,
                           banded_plan=_banded_plan_for(cfg),
                           eq_rows=_eq_rows_for(cfg), w_soft=aux.w,
                           a_pattern=_a_pattern_for(cfg))
    return _post_solve(cfg, carries, q0s, sol, aux)


def mpc_step(cfg: MPCConfig, tube: trj.TrajectoryTube,
             cache: hji_mod.HJICache, carry: MPCCarry, q0, u0, other_car, t,
             nodes_mode: str = "auto"):
    """One control step for one vehicle: `carry` without a batch dimension
    (`init_carry(cfg, None, ...)`), q0 (6,), u0 (3,), other_car (4,), t a
    number or a 0-d tensor; they are taken to the carry's device and
    dtype.  Returns (new carry, command (3,), diagnostics), unbatched.

    nodes_mode: "auto" seeds the coupled QP's nodes cold or warm by the
    carry's solved flag; "warm_only" skips the cold trim rollout, for a
    caller that knows the carry is warm (the JAX package's `mpc_step`).

    This is the JAX package's unbatched route, not `mpc_step_batched` at
    B=1: the horizon is linearized through the dense Van Loan stage
    matrix on `discretize.expm_dense`, the decoupled rollout is the
    sequential loop, and the QP is solved by the single-instance
    `solve_qp`: on backend "pallas" its segments run on the dense ADMM
    kernel at tile 1, on any other backend in plain PyTorch (the sparse
    QP's banded factor runs its plain stage scan there)."""
    _check_supported(cfg)
    if nodes_mode not in ("auto", "warm_only"):
        raise ValueError(f"nodes_mode must be 'auto' or 'warm_only', got "
                         f"{nodes_mode!r}")
    like = dict(dtype=carry.warm_x.dtype, device=carry.warm_x.device)
    lift = lambda v: torch.as_tensor(v, **like)[None]
    carry_b = MPCCarry(*[x[None] for x in carry])
    q0_b = lift(q0)
    qp, warm, aux = _pre_solve(cfg, tube, cache, carry_b, q0_b, lift(u0),
                               lift(other_car), lift(t), unbatched=True,
                               nodes_mode=nodes_mode)
    sol = solve_qp(QPData(*[x[0] for x in qp]),
                   QPWarmStart(*[x[0] for x in warm]), cfg.solver,
                   banded_plan=_banded_plan_for(cfg),
                   eq_rows=_eq_rows_for(cfg),
                   w_soft=None if aux.w is None else aux.w[0],
                   a_pattern=_a_pattern_for(cfg))
    new_carry, u3, diag = _post_solve(
        cfg, carry_b, q0_b, QPSolution(*[x[None] for x in sol]), aux)
    return (MPCCarry(*[x[0] for x in new_carry]), u3[0],
            StepDiagnostics(*[x[0] for x in diag]))


# ---------------------------------------------------------------------------
# Closed-loop simulation (reference `simulate`,
# src/model_predictive_control.jl:80-100)
# ---------------------------------------------------------------------------

class SimLog(NamedTuple):
    q: torch.Tensor        # (n_steps, 6) plant states
    u: torch.Tensor        # (n_steps, 3) commands in effect
    diag: StepDiagnostics  # stacked over the steps


def simulate(cfg: MPCConfig, tube: trj.TrajectoryTube,
             cache: hji_mod.HJICache, q0, u0=None, other_car=None,
             dt: float = 0.01, n_steps: int = 100, device=None) -> SimLog:
    """Closed loop for one vehicle: log, MPC step, propagate the plant
    with the *previous* command, adopt the new one (the reference loop's
    order).  q0 (6,) fixes the dtype; `tube` and `cache` must lie on
    `device` (None: the card)."""
    _check_supported(cfg)
    device = resolve_device(device)
    veh = cfg.veh
    q = torch.as_tensor(q0).to(device)
    like = dict(dtype=q.dtype, device=device)
    u = (torch.zeros(3, **like) if u0 is None
         else torch.as_tensor(u0, **like))
    other_car = torch.as_tensor(
        [1e4, 1e4, 0.0, 0.0] if other_car is None else other_car, **like)

    def f(q, ur):
        return dyn.vehicle_ode(veh, "bicycle", q, ur[..., :2], ur[..., 2:])

    carry = init_carry(cfg, None, dtype=q.dtype, device=device)
    q_log, u_log, diag_log = [], [], []
    for i in range(n_steps):
        carry, u_next, diag = mpc_step(cfg, tube, cache, carry, q, u,
                                       other_car, i * dt)
        ur = torch.cat([u[0:1], u[1:2] + u[2:3], torch.zeros(4, **like)])
        q_log.append(q)
        u_log.append(u)
        diag_log.append(diag)
        q = dz.propagate(f, q, ur, dt, substeps=cfg.sim_substeps)
        u = u_next
    return SimLog(q=torch.stack(q_log), u=torch.stack(u_log),
                  diag=StepDiagnostics(*[torch.stack(x)
                                         for x in zip(*diag_log)]))
