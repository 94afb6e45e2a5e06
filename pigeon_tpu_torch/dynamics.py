"""Vehicle dynamics library: Fiala brush tire model, planar bicycle ODE
variants, Uy-r stability envelope, longitudinal actuation split/limits, and
the steady-state trim estimator.

Counterpart of `pigeon_tpu/dynamics.py` (the reference's
`src/vehicle_dynamics.jl`).  Every function is branch-free (`torch.where`),
broadcasts over leading dimensions, and runs under `torch.func` forward
mode, which is how the horizon linearization differentiates `vehicle_ode`.
Limits use `math_utils.minimum/maximum/clip`, whose derivative at a tie
matches JAX's.

State/control conventions (trailing dimension, order as the reference
FieldVectors):

- bicycle state  q6 = (E, N, psi, Ux, Uy, r)
- tracking state q6t = (ds, Ux, Uy, r, dpsi, e)
- lateral state  q4 = (Uy, r, dpsi, e)
- 3-control      u3 = (delta, Fxf, Fxr)
- 2-control      u2 = (delta, Fx)
- road params    p4: bicycle (psi_r, kappa, theta, phi),
                 tracking (V, kappa, theta, phi), lateral (Ux, kappa, theta, phi)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pigeon_tpu_torch.config import VehicleParams
from pigeon_tpu_torch.math_utils import clip, maximum, minimum

_TINY = 1e-30


def _cbrt(x):
    """Real cube root (torch has no cbrt)."""
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Fiala brush tire model (reference: src/vehicle_dynamics.jl:35-62)
# ---------------------------------------------------------------------------

def _fiala(tan_alpha, Ca, Fy_max):
    """Lateral force from slip, cubic up to total slide."""
    tan_slide = 3.0 * Fy_max / Ca
    ratio = torch.abs(tan_alpha) / maximum(tan_slide, _TINY)
    cubic = -Ca * tan_alpha * (1.0 - ratio + ratio * ratio / 3.0)
    slide = -Fy_max * torch.sign(tan_alpha)
    return torch.where(ratio <= 1.0, cubic, slide)


def fiala_tire_model(alpha, Ca, mu, Fx, Fz):
    """Coupled-slip lateral tire force; the friction circle limits Fy by
    sqrt((mu Fz)^2 - Fx^2)."""
    F_max = mu * Fz
    Fy_max = torch.sqrt(maximum(F_max * F_max - Fx * Fx, 1e-9))
    val = _fiala(torch.tan(alpha), Ca, Fy_max)
    return torch.where(torch.abs(Fx) >= F_max, torch.zeros_like(val), val)


def _inv_fiala(Fy, Ca, Fy_max, corrected: bool = True):
    """Inverse of `_fiala`: slip tan(alpha) producing lateral force Fy.

    corrected=True restores the 3*Fy_max/Ca factor that the reference's
    unsaturated branch omits (see `pigeon_tpu.dynamics._inv_fiala`);
    corrected=False reproduces the reference formula verbatim."""
    tan_slide = 3.0 * Fy_max / Ca
    sat = -tan_slide * torch.sign(Fy)
    r = torch.abs(Fy) / maximum(Fy_max, _TINY)
    u = -(1.0 + _cbrt(r - 1.0)) * torch.sign(Fy)
    scale = tan_slide if corrected else 1.0
    return torch.where(torch.abs(Fy) >= Fy_max, sat, u * scale)


def inv_fiala_tire_model(Fy, Ca, mu, Fx, Fz):
    """Slip angle alpha producing lateral force Fy under longitudinal load
    Fx."""
    F_max = mu * Fz
    Fy_max = torch.sqrt(maximum(F_max * F_max - Fx * Fx, 1e-9))
    return torch.atan(_inv_fiala(Fy, Ca, Fy_max))


# ---------------------------------------------------------------------------
# Lateral force fixed point with longitudinal weight transfer
# (reference: src/vehicle_dynamics.jl:64-87)
# ---------------------------------------------------------------------------

def lateral_tire_forces_slip(veh: VehicleParams, alpha_f, alpha_r, Fxf, Fxr,
                             s_delta, c_delta, num_iters: int = 3):
    """Fixed point coupling the front normal load Fzf = (m G b - h Fx)/L
    with the tire model (3 iterations, the reference default)."""
    Fyf = torch.zeros_like(Fxf)
    Fx = Fxf * c_delta - Fyf * s_delta + Fxr
    for _ in range(num_iters):
        Fzf = (veh.m * veh.G * veh.b - veh.h * Fx) / veh.L
        Fyf = fiala_tire_model(alpha_f, veh.Caf, veh.mu, Fxf, Fzf)
        Fx = Fxf * c_delta - Fyf * s_delta + Fxr
    Fzr = (veh.m * veh.G * veh.a + veh.h * Fx) / veh.L
    Fyr = fiala_tire_model(alpha_r, veh.Car, veh.mu, Fxr, Fzr)
    return Fyf, Fyr


def slip_angles(veh: VehicleParams, Ux, Uy, r, delta):
    alpha_f = torch.atan2(Uy + veh.a * r, Ux) - delta
    alpha_r = torch.atan2(Uy - veh.b * r, Ux)
    return alpha_f, alpha_r


def lateral_tire_forces(veh: VehicleParams, Ux, Uy, r, u3,
                        num_iters: int = 3):
    """Lateral forces from body velocities and a 3-control."""
    delta, Fxf, Fxr = u3[..., 0], u3[..., 1], u3[..., 2]
    s_delta, c_delta = torch.sin(delta), torch.cos(delta)
    alpha_f, alpha_r = slip_angles(veh, Ux, Uy, r, delta)
    return lateral_tire_forces_slip(veh, alpha_f, alpha_r, Fxf, Fxr,
                                    s_delta, c_delta, num_iters)


def _planar_forces(veh: VehicleParams, Ux, Uy, r, delta, Fxf, Fxr):
    """Body-frame front-axle force components and the rear lateral force,
    shared by every bicycle variant."""
    s_delta, c_delta = torch.sin(delta), torch.cos(delta)
    alpha_f, alpha_r = slip_angles(veh, Ux, Uy, r, delta)
    Fyf, Fyr = lateral_tire_forces_slip(veh, alpha_f, alpha_r, Fxf, Fxr,
                                        s_delta, c_delta)
    Fxf_body = Fxf * c_delta - Fyf * s_delta
    Fyf_body = Fyf * c_delta + Fxf * s_delta
    return Fxf_body, Fyf_body, Fyr


def _drag(veh: VehicleParams, Ux):
    return -veh.Cd0 - Ux * (veh.Cd1 + veh.Cd2 * Ux)


# ---------------------------------------------------------------------------
# Bicycle ODE right-hand sides (reference: src/vehicle_dynamics.jl:111-224)
# ---------------------------------------------------------------------------

def bicycle_ode(veh: VehicleParams, q6, u3, p4=None):
    """World-frame planar bicycle ODE; p4 is accepted for interface parity
    (grade terms are zero as in the reference)."""
    E, N, psi, Ux, Uy, r = (q6[..., i] for i in range(6))
    delta, Fxf, Fxr = (u3[..., i] for i in range(3))
    s_psi, c_psi = torch.sin(psi), torch.cos(psi)
    Fxf_b, Fyf_b, Fyr = _planar_forces(veh, Ux, Uy, r, delta, Fxf, Fxr)
    Fx_drag = _drag(veh, Ux)
    return torch.stack([
        -Ux * s_psi - Uy * c_psi,          # psi measured from N
        Ux * c_psi - Uy * s_psi,
        r,
        (Fxf_b + Fxr + Fx_drag) / veh.m + r * Uy,
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz,
    ], dim=-1)


def tracking_ode(veh: VehicleParams, q6t, u3, p4):
    """Error-coordinate tracking bicycle ODE, p4 = (V, kappa, theta, phi)."""
    ds, Ux, Uy, r, dpsi, e = (q6t[..., i] for i in range(6))
    delta, Fxf, Fxr = (u3[..., i] for i in range(3))
    V, kappa = p4[..., 0], p4[..., 1]
    s_dpsi, c_dpsi = torch.sin(dpsi), torch.cos(dpsi)
    Fxf_b, Fyf_b, Fyr = _planar_forces(veh, Ux, Uy, r, delta, Fxf, Fxr)
    Fx_drag = _drag(veh, Ux)
    U_along = Ux * c_dpsi - Uy * s_dpsi
    return torch.stack([
        U_along - V,
        (Fxf_b + Fxr + Fx_drag) / veh.m + r * Uy,
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz,
        r - U_along * kappa,
        Ux * s_dpsi + Uy * c_dpsi,
    ], dim=-1)


def lateral_ode(veh: VehicleParams, q4, u3, p4):
    """Lateral-only tracking ODE, Ux exogenous via p4[0]."""
    Uy, r, dpsi, e = (q4[..., i] for i in range(4))
    delta, Fxf, Fxr = (u3[..., i] for i in range(3))
    Ux, kappa = p4[..., 0], p4[..., 1]
    s_dpsi, c_dpsi = torch.sin(dpsi), torch.cos(dpsi)
    _, Fyf_b, Fyr = _planar_forces(veh, Ux, Uy, r, delta, Fxf, Fxr)
    return torch.stack([
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz,
        r - Ux * kappa,
        Ux * s_dpsi + Uy * c_dpsi,
    ], dim=-1)


# ---------------------------------------------------------------------------
# Uy-r stability envelope (reference: src/vehicle_dynamics.jl:226-263)
# ---------------------------------------------------------------------------

class StableLimits(NamedTuple):
    delta_min: torch.Tensor
    delta_max: torch.Tensor
    H_veh: torch.Tensor   # (..., 4, 2): half-planes H [Uy, r]^T <= G
    G_veh: torch.Tensor   # (..., 4)


def stable_limits(veh: VehicleParams, Ux, Fxf, Fxr) -> StableLimits:
    """Safe-driving-envelope polytope in (Uy, r) plus steering bounds."""
    L, a, b, h, m, mu, Caf, Car, G = (veh.L, veh.a, veh.b, veh.h, veh.m,
                                      veh.mu, veh.Caf, veh.Car, veh.G)
    Fx = Fxf + Fxr
    Fzf = (m * G * b - h * Fx) / L
    Fzr = (m * G * a + h * Fx) / L
    Ff_max = mu * Fzf
    Fr_max = mu * Fzr
    zero = torch.zeros_like(Ff_max)
    Fyf_max = torch.where(
        torch.abs(Fxf) > Ff_max, zero,
        torch.sqrt(maximum(Ff_max * Ff_max - Fxf * Fxf, 0.0)))
    Fyr_max = torch.where(
        torch.abs(Fxr) > Fr_max, zero,
        torch.sqrt(maximum(Fr_max * Fr_max - Fxr * Fxr, 0.0)))
    tan_af_slide = 3.0 * Fyf_max / Caf
    tan_ar_slide = 3.0 * Fyr_max / Car
    af_slide = torch.atan(tan_af_slide)
    ar_slide = torch.atan(tan_ar_slide)

    Ux2 = Ux * Ux
    delta_max = torch.atan(L * (mu * G) / Ux2 - tan_ar_slide) + af_slide
    delta_min = torch.atan(L * (-mu * G) / Ux2 + tan_ar_slide) - af_slide
    rC = (mu * G) / Ux
    UyC = -Ux * tan_ar_slide + b * rC
    rD = Ux / L * (torch.tan(af_slide + delta_max) - tan_ar_slide)
    UyD = Ux * tan_ar_slide + b * rD
    mCD = (rD - rC) / (UyD - UyC)
    rE = Ux / L * (torch.tan(-af_slide + delta_min) + tan_ar_slide)
    UyE = -Ux * tan_ar_slide + b * rE
    rF = (-mu * G) / Ux
    UyF = Ux * tan_ar_slide + b * rF
    mEF = (rF - rE) / (UyF - UyE)

    one = torch.ones_like(Ux)
    H = torch.stack([
        torch.stack([one / Ux, -b / Ux * one], dim=-1),
        torch.stack([-one / Ux, b / Ux * one], dim=-1),
        torch.stack([-mCD, one], dim=-1),
        torch.stack([mEF, -one], dim=-1),
    ], dim=-2)
    Gv = torch.stack([ar_slide, ar_slide, rC - UyC * mCD, -rF + UyF * mEF],
                     dim=-1)
    return StableLimits(delta_min, delta_max, H, Gv)


# ---------------------------------------------------------------------------
# Longitudinal actuation and control limits
# (reference: src/vehicle_dynamics.jl:272-298)
# ---------------------------------------------------------------------------

def longitudinal_split(veh: VehicleParams, Fx):
    """Split commanded Fx into (Fxf, Fxr) per drive/brake fractions."""
    drive = Fx > 0
    Fxf = torch.where(drive, Fx * veh.fwd_frac, Fx * veh.fwb_frac)
    Fxr = torch.where(drive, Fx * veh.rwd_frac, Fx * veh.rwb_frac)
    return Fxf, Fxr


def apply_control_limits(veh: VehicleParams, u2, Ux):
    """Clamp (delta, Fx) to steering / force / power limits.

    `Ux.detach()` is the reference's `ForwardDiff.value` escape
    (src/vehicle_dynamics.jl:295): the power clamp contributes no dFx/dUx
    term to linearizations.  `torch.func.jacfwd` treats it as a stop
    gradient (tests/test_torch_dynamics.py)."""
    Ux = Ux.detach()
    delta = clip(u2[..., 0], -veh.delta_max, veh.delta_max)
    Fx = maximum(minimum(minimum(u2[..., 1], veh.Fx_max), veh.Px_max / Ux),
                 veh.Fx_min)
    return torch.stack([delta, Fx], dim=-1)


def expand_control(veh: VehicleParams, u2, Ux):
    """u2=(delta, Fx) -> limited u3=(delta, Fxf, Fxr)."""
    u2l = apply_control_limits(veh, u2, Ux)
    Fxf, Fxr = longitudinal_split(veh, u2l[..., 1])
    return torch.stack([u2l[..., 0], Fxf, Fxr], dim=-1)


def _get_Ux(model: str, q, p):
    if model == "bicycle":
        return q[..., 3]
    if model == "tracking":
        return q[..., 1]
    if model == "lateral":
        return p[..., 0]
    raise ValueError(model)


_ODES = {"bicycle": bicycle_ode, "tracking": tracking_ode,
         "lateral": lateral_ode}


def vehicle_ode(veh: VehicleParams, model: str, q, u2, p4):
    """`VehicleModel` ODE: reduced 2-D control -> limits -> split ->
    bicycle variant right-hand side."""
    Ux = _get_Ux(model, q, p4)
    u3 = expand_control(veh, u2, Ux)
    return _ODES[model](veh, q, u3, p4)


# ---------------------------------------------------------------------------
# Steady-state trim estimator (reference: src/vehicle_dynamics.jl:318-390)
# ---------------------------------------------------------------------------

class TrimEstimate(NamedTuple):
    beta: torch.Tensor
    Ux: torch.Tensor
    Uy: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    delta: torch.Tensor
    Fxf: torch.Tensor
    Fxr: torch.Tensor


def _like(v, V):
    return torch.broadcast_to(torch.as_tensor(v, dtype=V.dtype,
                                              device=V.device), V.shape)


def steady_state_estimates(veh: VehicleParams, V, A_tan, kappa,
                           num_iters: int = 4, r=None, beta0=0.0,
                           delta0=0.0, Fyf0=0.0,
                           corrected_tire_inverse: bool = True
                           ) -> TrimEstimate:
    """Iterative trim solve for (beta, delta, Fxf, Fxr, A) tracking speed V,
    tangential accel A_tan and curvature kappa under friction-circle
    prioritization (radial first); seeds the MPC linearization nodes.
    The same unrolled fixed point as `pigeon_tpu.dynamics`."""
    V = torch.as_tensor(V)
    A_tan = _like(A_tan, V)
    kappa = _like(kappa, V)
    r = V * kappa if r is None else _like(r, V)
    beta = _like(beta0, V)
    delta = _like(delta0, V)
    Fyf = _like(Fyf0, V)

    L, a, b, h, m, Izz, mu, G = (veh.L, veh.a, veh.b, veh.h, veh.m, veh.Izz,
                                 veh.mu, veh.G)
    Caf, Car = veh.Caf, veh.Car
    fwd, rwd, fwb, rwb = veh.fwd_frac, veh.rwd_frac, veh.fwb_frac, veh.rwb_frac

    # friction-circle prioritization of the nominal accelerations
    A_rad = V * V * kappa
    A_max = mu * G
    A_mag = torch.hypot(A_tan, A_rad)
    over = A_mag > A_max
    rad_over = torch.abs(A_rad) > A_max
    A_rad_c = torch.where(over & rad_over, A_max * torch.sign(A_rad), A_rad)
    A_tan_c = torch.where(
        over,
        torch.where(rad_over, torch.zeros_like(A_tan),
                    torch.sqrt(maximum(A_max * A_max - A_rad * A_rad, 0.0))
                    * torch.sign(A_tan)),
        A_tan)
    A_rad, A_tan = A_rad_c, A_tan_c
    r_dot = A_tan * kappa

    Ux = V
    Uy = torch.zeros_like(V)
    Fxf = torch.zeros_like(V)
    Fxr = torch.zeros_like(V)

    for i in range(num_iters):
        s_beta, c_beta = torch.sin(beta), torch.cos(beta)
        s_delta, c_delta = torch.sin(delta), torch.cos(delta)
        Ux, Uy = V * c_beta, V * s_beta
        Fx_drag = -veh.Cd0 - Ux * (veh.Cd1 + veh.Cd2 * Ux)

        Ax = A_tan * c_beta - A_rad * s_beta
        Ay = A_tan * s_beta + A_rad * c_beta
        Fx = Ax * m - Fx_drag
        Fx = minimum(
            Fx,
            minimum(veh.Px_max / Ux, veh.Fx_max)
            * (rwd + fwd * c_delta) - Fyf * s_delta)
        Fzr = (m * G * a + h * Fx) / L
        Fzf = (m * G * b - h * Fx) / L
        Fr_max, Ff_max = mu * Fzr, mu * Fzf

        frac = torch.where(Fx > 0, rwd / (rwd + fwd * c_delta),
                           rwb / (rwb + fwb * c_delta))
        Fxr = clip((Fx + Fyf * s_delta) * frac, -Fr_max, Fr_max)
        Fyr_max = torch.sqrt(maximum(Fr_max * Fr_max - Fxr * Fxr, 0.0))
        Fyr = (Ay * m - r_dot * Izz / a) / (1.0 + b / a)
        Fyr = clip(Fyr, -Fyr_max, Fyr_max)
        tan_ar = _inv_fiala(Fyr, Car, Fyr_max, corrected_tire_inverse)

        Fxf_b = clip(Fx - Fxr, -Ff_max, Ff_max)
        Fyf_b_max = torch.sqrt(maximum(Ff_max * Ff_max - Fxf_b * Fxf_b, 0.0))
        Fyf_b = clip((b * Fyr + r_dot * Izz) / a, -Fyf_b_max, Fyf_b_max)
        Fxf = Fxf_b * c_delta + Fyf_b * s_delta
        Fyf = Fyf_b * c_delta - Fxf_b * s_delta
        Fyf_max = torch.sqrt(maximum(Ff_max * Ff_max - Fxf * Fxf, 0.0))
        alpha_f = torch.atan(_inv_fiala(Fyf, Caf, Fyf_max,
                                        corrected_tire_inverse))
        delta = torch.atan2(Uy + a * r, Ux) - alpha_f

        if i == num_iters - 1:
            # the reference evaluates this with the trig of the pre-update
            # delta (src/vehicle_dynamics.jl:346,377-381)
            Ax = (Fxf * c_delta - Fyf * s_delta + Fxr + Fx_drag) / m
            Ay = (Fyf * c_delta + Fxf * s_delta + Fyr) / m
            A_tan = Ax * c_beta + Ay * s_beta
        else:
            beta = torch.atan(tan_ar + b * r / Ux)

    s_beta, c_beta = torch.sin(beta), torch.cos(beta)
    return TrimEstimate(beta=beta, Ux=V * c_beta, Uy=V * s_beta, r=r,
                        A=A_tan, delta=delta, Fxf=Fxf, Fxr=Fxr)
