"""Monte-Carlo scenario engine: the `dynamic_obstacle` configuration.
Counterpart of `pigeon_tpu/montecarlo.py`: thousands of perturbed (ego,
human) initial conditions roll out in closed loop at once, the HJI filter
active per scenario, and the safety and tracking statistics are reduced
on the device; `certify_avoidable` tells which scenarios some open-loop
evasion could survive.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.parallel.mesh import BatchedController, gather_batch


class ScenarioSet(NamedTuple):
    q0: torch.Tensor          # (B, 6) ego initial states
    other0: torch.Tensor      # (B, 4) human car initial states (E, N, psi, V)
    t0: torch.Tensor          # (B,) initial path times


def sample_scenarios(tube: trj.TrajectoryTube, B: int, seed: int = 0,
                     speed: float = 6.0, pos_noise: float = 0.5,
                     psi_noise: float = 0.05,
                     oncoming_gap: tuple = (15.0, 60.0),
                     oncoming_lateral: tuple = (-2.0, 2.0),
                     dtype=torch.float32) -> ScenarioSet:
    """Perturbed ego states along the path and an oncoming human car
    `gap` meters further along it, offset laterally, driving back along
    the path direction.  The draws come from `np.random.default_rng(seed)`
    in the JAX package's order, so both packages give the same scenarios.
    The set lies on the tube's device."""
    col = lambda v: v.detach().cpu().numpy()
    rng = np.random.default_rng(seed)
    n = int(tube.n_valid)
    k = rng.integers(0, max(1, n - 100), B)
    E = col(tube.E)[k] + rng.uniform(-pos_noise, pos_noise, B)
    N = col(tube.N)[k] + rng.uniform(-pos_noise, pos_noise, B)
    psi = col(tube.psi)[k] + rng.uniform(-psi_noise, psi_noise, B)
    q0 = np.stack([E, N, psi, np.full(B, speed), np.zeros(B), np.zeros(B)],
                  axis=1)
    t0 = col(tube.t)[k]

    gap = rng.uniform(*oncoming_gap, B)
    lat = rng.uniform(*oncoming_lateral, B)
    s_h = col(tube.s)[k] + gap
    dev = tube.E.device
    node = trj.eval_arclength(tube, torch.as_tensor(s_h, dtype=dtype,
                                                    device=dev))
    psi_n = col(node.psi)
    En = col(node.E) - lat * np.cos(psi_n)      # the path's left normal
    Nn = col(node.N) - lat * np.sin(psi_n)
    v_h = rng.uniform(2.0, 8.0, B)
    other0 = np.stack([En, Nn, psi_n + np.pi, v_h], axis=1)
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return ScenarioSet(q0=to(q0), other0=to(other0), t0=to(t0))


def certify_avoidable(veh, scen: ScenarioSet, n_steps: int = 500,
                      dt: float = 0.01, threshold: float = 2.5,
                      margin: float = 0.5):
    """Per-scenario avoidability certificate: a menu of 9 open-loop
    evasion policies (constant steering and Fx: bang-bang left or right
    at several braking levels, each clamped through the actuation limits
    every step) rolled out under the nonlinear bicycle model against the
    constant-velocity human; a scenario is avoidable if some policy keeps
    the separation at least threshold + margin over the episode.  All
    policies of all scenarios step together, (B, 9) states, in a loop of
    `n_steps` RK4 steps on the scenarios' device.

    Returns (avoidable (B,) bool, best policy's least separation (B,))."""
    d = veh.delta_max
    q0, oc = scen.q0, scen.other0
    menu = q0.new_tensor([
        [d, 0.0], [-d, 0.0],
        [d, veh.Fx_min], [-d, veh.Fx_min],
        [0.5 * d, veh.Fx_min], [-0.5 * d, veh.Fx_min],
        [0.0, veh.Fx_min],
        [d, 0.5 * veh.Fx_min], [-d, 0.5 * veh.Fx_min],
    ])                                                  # (K, 2)
    B, K = q0.shape[0], menu.shape[0]
    u2 = menu.expand(B, K, 2)
    f = lambda q_, r: dyn.vehicle_ode(veh, "bicycle", q_, r[..., :2],
                                      r[..., 2:])
    q = q0[:, None, :].expand(B, K, 6)
    zeros = q.new_zeros((B, K, 4))
    min_sep = torch.hypot(q0[:, 0] - oc[:, 0], q0[:, 1] - oc[:, 1])
    min_sep = min_sep[:, None].expand(B, K)
    for _ in range(n_steps):
        E, N, psi, V = oc.unbind(-1)
        oc = torch.stack([E - V * torch.sin(psi) * dt,
                          N + V * torch.cos(psi) * dt, psi, V], dim=-1)
        u2c = dyn.apply_control_limits(veh, u2, q[..., 3])
        Fxf, Fxr = dyn.longitudinal_split(veh, u2c[..., 1])
        ur = torch.cat([torch.stack([u2c[..., 0], Fxf + Fxr], dim=-1),
                        zeros], dim=-1)
        q = dz.propagate(f, q, ur, dt)
        sep = torch.hypot(q[..., 0] - oc[:, None, 0],
                          q[..., 1] - oc[:, None, 1])
        min_sep = torch.minimum(min_sep, sep)
    best = min_sep.amax(dim=-1)
    return best >= threshold + margin, best


class MonteCarloSummary(NamedTuple):
    n_scenarios: int
    n_steps: int
    min_separation_m: float        # fleet-wide least car-to-car distance
    collision_frac: float          # scenarios whose separation < threshold
    hji_active_frac: float         # share of steps with the filter active
    tracking_e_p50: float
    tracking_e_p99: float
    converged_frac: float
    controls_finite: bool


class PerScenario(NamedTuple):
    """Per-scenario rollout outcomes (for certified-subset analysis)."""

    min_separation_m: torch.Tensor   # (B,)
    collided: torch.Tensor           # (B,) bool
    converged_frac: torch.Tensor     # (B,) share of steps converged
    hji_active_frac: torch.Tensor    # (B,)
    V_min: torch.Tensor              # (B,) least finite V seen (inf if none)


def percentile(x, p: float) -> float:
    """`jnp.percentile(x, p)` over all entries: linear interpolation
    between the two nearest order statistics, NaN if any entry is NaN.
    (`torch.quantile` refuses inputs of more than 2^24 entries.)"""
    v = torch.sort(x.reshape(-1)).values
    if bool(torch.isnan(v).any()):
        return float("nan")
    q = p / 100.0 * (v.numel() - 1)
    lo, hi = int(np.floor(q)), int(np.ceil(q))
    w = q - lo
    return float(v[lo] * (1.0 - w) + v[hi] * w)


def run_dynamic_obstacle(cfg: mpc_mod.MPCConfig, tube: trj.TrajectoryTube,
                         cache: hji_mod.HJICache, scen: ScenarioSet,
                         n_steps: int = 200, dt: float = 0.01,
                         collision_threshold: float = 2.5,
                         mesh=None, per_scenario: bool = False):
    """Every scenario in closed loop with a constant-velocity human, each
    anchored at its own path time; the statistics are reduced on the
    device and read once at the end.  per_scenario=True also returns the
    `PerScenario` record: (summary, per).

    `mesh` (`parallel.mesh.make_mesh`): every rank passes the whole
    scenario set and rolls out its shard; the summary is the whole
    fleet's on every rank (the per-scenario quantities it reads, 4 n_steps
    B values, all-gathered and reduced as without a mesh, so it is the
    same to the bit) and `PerScenario` is the rank's shard."""
    ctrl = BatchedController(cfg, tube, cache=cache, mesh=mesh, dt=dt)
    state = ctrl.init_state(scen.q0)
    state, (q_log, u_log, oc_log, diag) = ctrl.rollout(
        state, n_steps, other_car=scen.other0, t0=scen.t0)
    sep = torch.hypot(q_log[..., 0] - oc_log[..., 0],
                      q_log[..., 1] - oc_log[..., 1])      # (n_steps, B)
    min_sep_per = sep.amin(dim=0)
    fleet = (min_sep_per, diag.e.abs(), diag.hji_active, diag.converged,
             torch.isfinite(u_log).all(dim=-1))
    if mesh is not None:
        fleet = (gather_batch(fleet[0], mesh),
                 *gather_batch(fleet[1:], mesh, dim=1))
    summary = _summary(scen, n_steps, *fleet, collision_threshold)
    if not per_scenario:
        return summary
    Vh = diag.V_hji
    per = PerScenario(
        min_separation_m=min_sep_per,
        collided=min_sep_per < collision_threshold,
        converged_frac=diag.converged.float().mean(dim=0),
        hji_active_frac=diag.hji_active.float().mean(dim=0),
        V_min=torch.where(torch.isfinite(Vh), Vh,
                          torch.full_like(Vh, torch.inf)).amin(dim=0))
    return summary, per


def _summary(scen, n_steps, min_sep_per, e_abs, hji_active, converged,
             finite, collision_threshold):
    """The fleet's summary from its per-scenario quantities: min_sep_per
    (B,), and |e|, the filter's and the solver's flags and the finite
    commands, each (n_steps, B)."""
    return MonteCarloSummary(
        n_scenarios=int(scen.q0.shape[0]),
        n_steps=n_steps,
        min_separation_m=float(min_sep_per.min()),
        collision_frac=float((min_sep_per < collision_threshold)
                             .float().mean()),
        hji_active_frac=float(hji_active.float().mean()),
        tracking_e_p50=percentile(e_abs, 50),
        tracking_e_p99=percentile(e_abs, 99),
        converged_frac=float(converged.float().mean()),
        controls_finite=bool(finite.all()))
