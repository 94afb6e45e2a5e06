"""Parity harness: the deviation set against the reference-faithful
closed loop.  Counterpart of `pigeon_tpu/parity.py`.

The port ships the JAX package's deliberate deviations from the
reference: a corrected inverse-tire formula, the exact exponential
discretization in place of the single-step RK4 linearization, and an
actuation clamp on the published command.  `faithful_config` undoes all
three (the reference's `_invfialatiremodel` without the 3 Fy_max / Ca
factor, src/vehicle_dynamics.jl:56-62; the RK4 linearization,
src/coupled_lat_long.jl:253,262; the raw command,
src/coupled_lat_long.jl:370-374) and `compare` runs both through the same
closed loop (`mpc.simulate`, src/model_predictive_control.jl:80-100) on a
recorded X1 `.world` path, reporting the control-sequence deltas.

    python -m pigeon_tpu_torch.parity --device cpu [--steps 300]
        [--paths ...] [--formulations coupled decoupled] [--lin-substeps 1]

The loops run in float64, as the JAX harness does: PARITY_SOLVER's
tolerance of 1e-6 is out of float32's reach (a float32 solve spends its
whole 10,000-iteration budget on every step, so the converged prefix the
deltas cover would end at the first step).  The card's kernels take
float32 only, so the harness runs on the CPU's plain versions and raises
for any other device, the default (the card) included.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.config import SolverOptions

REFERENCE_PATHS = "/root/reference/test/path"
ALL_WORLDS = ("skidpadoval", "newskidpadoval", "flidpadoval", "paddockoval",
              "EastPaddock", "westpaddock", "curvy", "vail")

# Solver settings for parity runs: a tight tolerance, a large budget and
# the exact factorization, so that solver differences do not enter the
# algorithmic comparison (early exit every 50 iterations keeps the budget
# free on healthy steps)
PARITY_SOLVER = SolverOptions(eps_abs=1e-6, eps_rel=1e-6, max_iter=10000,
                              check_every=50, backend="xla",
                              factor_method="chol", scaling_iters=10)


def stiff_eigenvalue(veh, V: float, kappa: float = 0.02) -> complex:
    """The dominant (most negative) eigenvalue of the continuous tracking
    dynamics linearized at the trim for speed V: the lateral tire
    relaxation mode, which scales like -Ca / (m Ux), so slow paths are the
    stiff ones."""
    f64 = dict(dtype=torch.float64)
    est = dyn.steady_state_estimates(veh, torch.tensor(V, **f64), 0.0,
                                     kappa)
    zero = torch.zeros((), **f64)
    q = torch.stack([zero, est.Ux, est.Uy, est.r, -est.beta, zero])[None]
    ur = torch.stack([est.delta, est.Fxf + est.Fxr, torch.tensor(V, **f64),
                      torch.tensor(kappa, **f64), zero, zero])[None]
    J, _ = dz.batched_jacobians(
        lambda q_, ur_: dyn.vehicle_ode(veh, "tracking", q_, ur_[..., :2],
                                        ur_[..., 2:]), q, ur)
    ev = np.linalg.eigvals(J[0].numpy())
    return complex(ev[np.argmax(np.abs(ev.real))])


def rk4_amplification(z: complex) -> float:
    """|R(z)| of the classical RK4 stability polynomial."""
    R = 1 + z + z ** 2 / 2 + z ** 3 / 6 + z ** 4 / 24
    return abs(R)


def stable_substeps(veh, tube: trj.TrajectoryTube, dt_long: float = 0.2,
                    target_R: float = 0.8) -> int:
    """The least RK4 substep count over dt_long (of 1, 2, 4, ..., 32, else
    64) that keeps the faithful linearization inside the RK4 stability
    region, |R| <= target_R, at the path's slowest speed."""
    V_min = float(tube.V[:tube.n_valid].min())
    lam = stiff_eigenvalue(veh, max(V_min, 1.0))
    for sub in (1, 2, 4, 8, 16, 32):
        if rk4_amplification(lam * dt_long / sub) <= target_R:
            return sub
    return 64


def faithful_config(cfg: mpc_mod.MPCConfig,
                    lin_substeps: int = 1) -> mpc_mod.MPCConfig:
    """The reference-faithful variant of `cfg`: the reference tire
    inverse, the RK4 linearization with `lin_substeps` steps a stage,
    unclamped commands and PARITY_SOLVER.

    lin_substeps = 1 is the literal reference algorithm; its long-horizon
    (dt_long = 0.2) models amplify the stiff lateral tire modes
    (|R(lambda h)| >> 1), the reference's own instability, reproduced
    deliberately.  Only the coupled formulation reads it: the decoupled
    controller already uses the exact double linearization."""
    return dataclasses.replace(
        cfg, tire_inverse="reference", lin_method="rk4",
        lin_substeps=lin_substeps, clamp_commands=False,
        solver=PARITY_SOLVER)


def deviation_config(cfg: mpc_mod.MPCConfig) -> mpc_mod.MPCConfig:
    """The deviation set under the same parity solver settings."""
    return dataclasses.replace(cfg, solver=PARITY_SOLVER)


class ParityResult(NamedTuple):
    path: str
    formulation: str
    n_steps: int
    prefix_steps: int          # mutually converged prefix the deltas cover
    max_d_delta_rad: float     # max |delta_dev - delta_faithful| on prefix
    max_d_Fx_N: float          # max |Fx_dev - Fx_faithful| on prefix
    rms_d_delta_rad: float
    rms_d_Fx_N: float
    max_e_faithful_m: float    # faithful closed-loop tracking error (full)
    max_e_deviation_m: float
    conv_frac_faithful: float  # solver convergence rate over the full run
    conv_frac_deviation: float
    faithful_finite: bool
    deviation_finite: bool


def _float64_device(device) -> torch.device:
    """The harness's device: the CPU, where the loops run in float64
    (ValueError for the card, whose kernels take float32 only)."""
    device = resolve_device(device)
    if device.type != "cpu":
        raise ValueError(
            "the parity harness runs in float64 (PARITY_SOLVER's tolerance "
            "of 1e-6 is out of float32's reach) and the card's kernels take "
            f"float32 only; got device {device}: pass device='cpu'")
    return device


def run_closed_loop(cfg: mpc_mod.MPCConfig, world: str, n_steps: int,
                    pad_to: int = 1024, start_t: float = 0.5,
                    offset_e: float = 0.3, offset_psi: float = 0.03,
                    device=None):
    """The float64 closed loop on a `.world` path from a perturbed start
    pose (a lateral offset and a heading error, so that the comparison
    covers the transient), on `device` (the CPU; see the module's
    docstring).

    Returns numpy (u_log (n, 3), e_log (n,), q_log (n, 6), converged
    (n,))."""
    device = _float64_device(device)
    like = dict(dtype=torch.float64, device=device)
    tube = trj.tube_from_world(
        os.path.join(REFERENCE_PATHS, world + ".world"), pad_to=pad_to,
        **like)
    cache = hji_mod.inactive_cache(device=device)
    node = trj.eval_time(tube, torch.tensor(start_t, **like))
    psi = float(node.psi)
    # the left normal (e > 0 is left of the path), from the local tangent
    node2 = trj.eval_arclength(tube, node.s + 0.5)
    tx, ty = float(node2.E - node.E), float(node2.N - node.N)
    tn = np.hypot(tx, ty)
    nx, ny = -ty / tn, tx / tn
    q0 = torch.tensor([float(node.E) + offset_e * nx,
                       float(node.N) + offset_e * ny, psi + offset_psi,
                       float(node.V), 0.0, 0.0], **like)
    log = mpc_mod.simulate(cfg, tube, cache, q0, dt=0.01, n_steps=n_steps,
                           device=device)
    as_np = lambda x: x.cpu().numpy()
    return (as_np(log.u), as_np(log.diag.e), as_np(log.q),
            as_np(log.diag.converged))


def compare(world: str, formulation: str = "coupled", n_steps: int = 200,
            lin_substeps: int = 1, hz=None, device=None) -> ParityResult:
    """Deviation set against reference-faithful control sequences on one
    path, in float64 on `device` (the CPU; ValueError for the card)."""
    _float64_device(device)
    base = (mpc_mod.x1_coupled_config() if formulation == "coupled"
            else mpc_mod.x1_decoupled_config())
    if hz is not None:
        base = dataclasses.replace(base, hz=hz)
    run = lambda cfg: run_closed_loop(cfg, world, n_steps, device=device)
    u_dev, e_dev, _, c_dev = run(deviation_config(base))
    u_fai, e_fai, _, c_fai = run(faithful_config(base, lin_substeps))

    # the deltas mean something only while both solvers converge: once
    # either run publishes an unconverged iterate, the loops decouple
    both = c_dev & c_fai
    bad = np.nonzero(~both)[0]
    prefix = max(int(bad[0]) if bad.size else n_steps, 1)
    sl = slice(0, prefix)

    d_delta = np.abs(u_dev[sl, 0] - u_fai[sl, 0])
    d_Fx = np.abs((u_dev[sl, 1] + u_dev[sl, 2])
                  - (u_fai[sl, 1] + u_fai[sl, 2]))
    return ParityResult(
        path=world, formulation=formulation, n_steps=n_steps,
        prefix_steps=prefix,
        max_d_delta_rad=float(np.max(d_delta)),
        max_d_Fx_N=float(np.max(d_Fx)),
        rms_d_delta_rad=float(np.sqrt(np.mean(d_delta ** 2))),
        rms_d_Fx_N=float(np.sqrt(np.mean(d_Fx ** 2))),
        max_e_faithful_m=float(np.max(np.abs(e_fai))),
        max_e_deviation_m=float(np.max(np.abs(e_dev))),
        conv_frac_faithful=float(np.mean(c_fai)),
        conv_frac_deviation=float(np.mean(c_dev)),
        faithful_finite=bool(np.all(np.isfinite(u_fai))),
        deviation_finite=bool(np.all(np.isfinite(u_dev))),
    )


def _main():
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--paths", nargs="*", default=list(ALL_WORLDS))
    ap.add_argument("--formulations", nargs="*",
                    default=["coupled", "decoupled"])
    ap.add_argument("--lin-substeps", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device: cpu (the default, the card, raises: "
                         "the harness runs in float64)")
    args = ap.parse_args()

    rows = []
    for form in args.formulations:
        for w in args.paths:
            r = compare(w, form, args.steps, args.lin_substeps,
                        device=args.device)
            rows.append(r._asdict())
            print(json.dumps(r._asdict()), flush=True)
    print("\n| path | form | prefix | max dDelta (mrad) | max dFx (N) | "
          "rms dDelta (mrad) | rms dFx (N) | max e faith (mm) | "
          "max e dev (mm) | conv faith | conv dev |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['path']} | {r['formulation']} "
              f"| {r['prefix_steps']}/{r['n_steps']} "
              f"| {1e3*r['max_d_delta_rad']:.2f} | {r['max_d_Fx_N']:.0f} "
              f"| {1e3*r['rms_d_delta_rad']:.3f} | {r['rms_d_Fx_N']:.1f} "
              f"| {1e3*r['max_e_faithful_m']:.1f} "
              f"| {1e3*r['max_e_deviation_m']:.1f} "
              f"| {r['conv_frac_faithful']:.2f} "
              f"| {r['conv_frac_deviation']:.2f} |")


if __name__ == "__main__":
    _main()
