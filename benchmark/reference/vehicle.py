"""The X1 vehicle (Pigeon.jl `X1()`, src/vehicles.jl:1-59) and its
dynamics: the Fiala brush tire, the planar bicycle in world and in path
coordinates, the lateral-only model, the stable-handling envelope, the
actuator limits and the steady-state trim (src/vehicle_dynamics.jl).

The one departure from plain elementwise code is `limit`: a saturating
actuator limit whose derivative, inside a band around a bound, takes a
weight the caller chooses.  The controller linearizes through these
limits, and a node that lies within rounding of a bound has a derivative
that the rounding decides; the comparison tries each weight there, for
the steering and the force limit apart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

_TINY = 1e-30


@dataclasses.dataclass(frozen=True)
class Vehicle:
    L: float
    a: float
    b: float
    h: float
    G: float
    m: float
    Izz: float
    mu: float
    Caf: float
    Car: float
    Cd0: float
    Cd1: float
    Cd2: float
    fwd_frac: float
    rwd_frac: float
    fwb_frac: float
    rwb_frac: float
    Fx_max: float
    Fx_min: float
    Px_max: float
    delta_max: float
    kappa_max: float


def x1() -> Vehicle:
    G = 9.80665
    mfl, mfr, mrl, mrr = 484.0, 455.0, 521.0, 504.0
    m = mfl + mfr + mrl + mrr
    L = 2.87
    a = (mrl + mrr) / m * L
    b = (mfl + mfr) / m * L
    h = 0.1 * b / L + 0.1 * a / L + 0.37
    mu = 0.92
    fwb = 0.6
    Fx_min = max(-m * G * a * mu / (L * (1.0 - fwb) + mu * h),
                 -m * G * b * mu / (L * fwb - mu * h))
    delta_max = 18.0 * math.pi / 180.0
    return Vehicle(L=L, a=a, b=b, h=h, G=G, m=m, Izz=2900.0, mu=mu,
                   Caf=150e3, Car=220e3, Cd0=241.0, Cd1=25.1, Cd2=0.0,
                   fwd_frac=0.0, rwd_frac=1.0, fwb_frac=fwb,
                   rwb_frac=1.0 - fwb, Fx_max=5600.0, Fx_min=Fx_min,
                   Px_max=75e3, delta_max=delta_max,
                   kappa_max=math.tan(delta_max) / L)


def u_normalization(veh: Vehicle):
    """(delta, Fx) scales of the coupled QP's normalized controls."""
    return (veh.delta_max, max(-veh.Fx_min, veh.Fx_max))


@dataclasses.dataclass(frozen=True)
class Ties:
    """Derivative of the actuator limits: 1 strictly inside, 0 beyond,
    one half at an exact tie; within `band` (relative, with a floor of 1)
    of a bound, `delta` for the steering limit and `Fx` for the force
    limit.  The force's split between the axles (`split`): by its sign,
    or where it lies within `split_band` (N) of 0, the drive fractions
    (`split` 1) or the brake fractions (`split` -1)."""
    band: float = 0.0
    delta: float = 0.5
    Fx: float = 0.5
    split: int = 0
    split_band: float = 0.0


EXACT = Ties()


def minimum(x, y):
    return torch.minimum(x, y if isinstance(y, torch.Tensor)
                         else torch.full_like(x, y))


def maximum(x, y):
    return torch.maximum(x, y if isinstance(y, torch.Tensor)
                         else torch.full_like(x, y))


def limit(u, lo, hi, band: float = 0.0, weight: float = 0.5,
          lo_last: bool = False):
    """min(max(u, lo), hi), or with `lo_last` max(min(u, hi), lo) (which
    differ where hi < lo); its derivative in u is 1 strictly inside, 0
    beyond, one half at an exact tie, and `weight` within `band` of a
    bound (`Ties`); lo and hi carry no derivative."""
    lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device).detach()
    hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device).detach()
    ud = u.detach()
    val = (torch.maximum(torch.minimum(ud, hi), lo) if lo_last
           else torch.minimum(torch.maximum(ud, lo), hi))
    w = ((ud > lo) & (ud < hi)).to(u.dtype)
    w = torch.where((ud == lo) | (ud == hi), torch.full_like(w, 0.5), w)
    if band > 0.0:
        near = lambda bnd: (ud - bnd).abs() <= band * torch.clamp(
            bnd.abs(), min=1.0)
        w = torch.where(near(lo) | near(hi), torch.full_like(w, weight), w)
    return val + w * (u - ud)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _fiala(tan_alpha, Ca, Fy_max):
    tan_slide = 3.0 * Fy_max / Ca
    ratio = torch.abs(tan_alpha) / maximum(tan_slide, _TINY)
    cubic = -Ca * tan_alpha * (1.0 - ratio + ratio * ratio / 3.0)
    slide = -Fy_max * torch.sign(tan_alpha)
    return torch.where(ratio <= 1.0, cubic, slide)


def fiala(alpha, Ca, mu, Fx, Fz):
    F_max = mu * Fz
    Fy_max = torch.sqrt(maximum(F_max * F_max - Fx * Fx, 1e-9))
    val = _fiala(torch.tan(alpha), Ca, Fy_max)
    return torch.where(torch.abs(Fx) >= F_max, torch.zeros_like(val), val)


def inv_fiala(Fy, Ca, Fy_max):
    """tan(alpha) giving lateral force Fy (the unsaturated branch scaled
    by 3 Fy_max / Ca, the inverse of `_fiala`)."""
    tan_slide = 3.0 * Fy_max / Ca
    sat = -tan_slide * torch.sign(Fy)
    r = torch.abs(Fy) / maximum(Fy_max, _TINY)
    u = -(1.0 + _cbrt(r - 1.0)) * torch.sign(Fy)
    return torch.where(torch.abs(Fy) >= Fy_max, sat, u * tan_slide)


def lateral_forces_slip(veh, alpha_f, alpha_r, Fxf, Fxr, s_d, c_d,
                        num_iters: int = 3):
    """Front load transfer fixed point, then both axles' lateral force."""
    Fyf = torch.zeros_like(Fxf)
    Fx = Fxf * c_d - Fyf * s_d + Fxr
    for _ in range(num_iters):
        Fzf = (veh.m * veh.G * veh.b - veh.h * Fx) / veh.L
        Fyf = fiala(alpha_f, veh.Caf, veh.mu, Fxf, Fzf)
        Fx = Fxf * c_d - Fyf * s_d + Fxr
    Fzr = (veh.m * veh.G * veh.a + veh.h * Fx) / veh.L
    return Fyf, fiala(alpha_r, veh.Car, veh.mu, Fxr, Fzr)


def slip_angles(veh, Ux, Uy, r, delta):
    return (torch.atan2(Uy + veh.a * r, Ux) - delta,
            torch.atan2(Uy - veh.b * r, Ux))


def lateral_forces(veh, Ux, Uy, r, u3):
    delta, Fxf, Fxr = u3[..., 0], u3[..., 1], u3[..., 2]
    af, ar = slip_angles(veh, Ux, Uy, r, delta)
    return lateral_forces_slip(veh, af, ar, Fxf, Fxr, torch.sin(delta),
                               torch.cos(delta))


def _planar(veh, Ux, Uy, r, delta, Fxf, Fxr):
    s_d, c_d = torch.sin(delta), torch.cos(delta)
    af, ar = slip_angles(veh, Ux, Uy, r, delta)
    Fyf, Fyr = lateral_forces_slip(veh, af, ar, Fxf, Fxr, s_d, c_d)
    return Fxf * c_d - Fyf * s_d, Fyf * c_d + Fxf * s_d, Fyr


def _drag(veh, Ux):
    return -veh.Cd0 - Ux * (veh.Cd1 + veh.Cd2 * Ux)


def bicycle(veh, q, u3):
    """World frame (E, N, psi, Ux, Uy, r), psi measured from N."""
    E, N, psi, Ux, Uy, r = q.unbind(-1)
    Fxf_b, Fyf_b, Fyr = _planar(veh, Ux, Uy, r, *u3.unbind(-1))
    s, c = torch.sin(psi), torch.cos(psi)
    return torch.stack([
        -Ux * s - Uy * c, Ux * c - Uy * s, r,
        (Fxf_b + u3[..., 2] + _drag(veh, Ux)) / veh.m + r * Uy,
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz], dim=-1)


def tracking(veh, q, u3, p):
    """Path frame (ds, Ux, Uy, r, dpsi, e), p = (V, kappa, ., .)."""
    ds, Ux, Uy, r, dpsi, e = q.unbind(-1)
    V, kappa = p[..., 0], p[..., 1]
    Fxf_b, Fyf_b, Fyr = _planar(veh, Ux, Uy, r, *u3.unbind(-1))
    s, c = torch.sin(dpsi), torch.cos(dpsi)
    along = Ux * c - Uy * s
    return torch.stack([
        along - V,
        (Fxf_b + u3[..., 2] + _drag(veh, Ux)) / veh.m + r * Uy,
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz,
        r - along * kappa,
        Ux * s + Uy * c], dim=-1)


def lateral(veh, q, u3, p):
    """(Uy, r, dpsi, e) with Ux = p[0] given, p = (Ux, kappa, ., .)."""
    Uy, r, dpsi, e = q.unbind(-1)
    Ux, kappa = p[..., 0], p[..., 1]
    _, Fyf_b, Fyr = _planar(veh, Ux, Uy, r, *u3.unbind(-1))
    return torch.stack([
        (Fyf_b + Fyr) / veh.m - r * Ux,
        (veh.a * Fyf_b - veh.b * Fyr) / veh.Izz,
        r - Ux * kappa,
        Ux * torch.sin(dpsi) + Uy * torch.cos(dpsi)], dim=-1)


def split(veh, Fx, ties: Ties = EXACT):
    """(Fxf, Fxr) of a total force: drive or brake fractions."""
    drive = Fx > 0
    if ties.split:
        near = Fx.detach().abs() <= ties.split_band
        drive = torch.where(near, torch.full_like(drive, ties.split > 0),
                            drive)
    return (torch.where(drive, Fx * veh.fwd_frac, Fx * veh.fwb_frac),
            torch.where(drive, Fx * veh.rwd_frac, Fx * veh.rwb_frac))


def control_limits(veh, u2, Ux, ties: Ties = EXACT):
    """(delta, Fx) clamped to the steering, force and power limits, the
    braking limit last (it wins where a negative Ux makes the power
    limit negative); Ux carries no derivative (the reference's
    ForwardDiff.value)."""
    Ux = Ux.detach()
    delta = limit(u2[..., 0], -veh.delta_max, veh.delta_max, ties.band,
                  ties.delta)
    hi = torch.clamp(veh.Px_max / Ux, max=veh.Fx_max)
    return torch.stack([delta, limit(u2[..., 1], veh.Fx_min, hi, ties.band,
                                     ties.Fx, lo_last=True)], dim=-1)


def ode(veh, model: str, q, u2, p, ties: Ties = EXACT):
    """The model's right-hand side from the 2-control (delta, Fx)."""
    Ux = {"bicycle": lambda: q[..., 3], "tracking": lambda: q[..., 1],
          "lateral": lambda: p[..., 0]}[model]()
    u2l = control_limits(veh, u2, Ux, ties)
    Fxf, Fxr = split(veh, u2l[..., 1], ties)
    u3 = torch.stack([u2l[..., 0], Fxf, Fxr], dim=-1)
    if model == "bicycle":
        return bicycle(veh, q, u3)
    return (tracking if model == "tracking" else lateral)(veh, q, u3, p)


class Envelope(NamedTuple):
    delta_min: torch.Tensor
    delta_max: torch.Tensor
    H: torch.Tensor   # (..., 4, 2): H [Uy, r]' <= Gv
    Gv: torch.Tensor  # (..., 4)
    # how far the slopes of the corner lines are from 0/0 (relative): with
    # both axles past their friction limits the corners coincide and the
    # slopes are rounding noise
    cond: torch.Tensor


def envelope(veh, Ux, Fxf, Fxr) -> Envelope:
    """Stable-handling polytope in (Uy, r) and the steering bounds."""
    L, a, b, h, m, mu, G = veh.L, veh.a, veh.b, veh.h, veh.m, veh.mu, veh.G
    Fx = Fxf + Fxr
    Ff_max = mu * (m * G * b - h * Fx) / L
    Fr_max = mu * (m * G * a + h * Fx) / L
    zero = torch.zeros_like(Ff_max)
    Fyf_max = torch.where(torch.abs(Fxf) > Ff_max, zero, torch.sqrt(
        maximum(Ff_max * Ff_max - Fxf * Fxf, 0.0)))
    Fyr_max = torch.where(torch.abs(Fxr) > Fr_max, zero, torch.sqrt(
        maximum(Fr_max * Fr_max - Fxr * Fxr, 0.0)))
    tf = 3.0 * Fyf_max / veh.Caf
    tr = 3.0 * Fyr_max / veh.Car
    af, ar = torch.atan(tf), torch.atan(tr)
    Ux2 = Ux * Ux
    d_max = torch.atan(L * (mu * G) / Ux2 - tr) + af
    d_min = torch.atan(L * (-mu * G) / Ux2 + tr) - af
    rC = (mu * G) / Ux
    UyC = -Ux * tr + b * rC
    rD = Ux / L * (torch.tan(af + d_max) - tr)
    UyD = Ux * tr + b * rD
    mCD = (rD - rC) / (UyD - UyC)
    rE = Ux / L * (torch.tan(-af + d_min) + tr)
    UyE = -Ux * tr + b * rE
    rF = (-mu * G) / Ux
    UyF = Ux * tr + b * rF
    mEF = (rF - rE) / (UyF - UyE)
    one = torch.ones_like(Ux)
    H = torch.stack([torch.stack([one / Ux, -b / Ux * one], -1),
                     torch.stack([-one / Ux, b / Ux * one], -1),
                     torch.stack([-mCD, one], -1),
                     torch.stack([mEF, -one], -1)], dim=-2)
    Gv = torch.stack([ar, ar, rC - UyC * mCD, -rF + UyF * mEF], dim=-1)
    rel = lambda a, b: (a - b).abs() / (a.abs() + b.abs() + 1e-30)
    cond = torch.minimum(torch.minimum(rel(UyD, UyC), rel(rD, rC)),
                         torch.minimum(rel(UyF, UyE), rel(rF, rE)))
    return Envelope(d_min, d_max, H, Gv, cond)


# friction margins within which a linearization is rounding noise
FRICTION_BAND = 1e-2


def friction_margin(veh, Fx):
    """Of a total force Fx, the axle nearer its friction circle's |F_max^2
    - Fx_axle^2| / F_max^2 (static load transfer): near 0 an axle's
    lateral force limit sqrt(F_max^2 - Fx_axle^2) has an unbounded
    derivative, so a linearization or an envelope there is rounding
    noise."""
    Fxf, Fxr = split(veh, Fx)
    Ff = veh.mu * (veh.m * veh.G * veh.b - veh.h * Fx) / veh.L
    Fr = veh.mu * (veh.m * veh.G * veh.a + veh.h * Fx) / veh.L
    return torch.minimum(((Ff * Ff - Fxf * Fxf) / (Ff * Ff)).abs(),
                         ((Fr * Fr - Fxr * Fxr) / (Fr * Fr)).abs())


class Trim(NamedTuple):
    beta: torch.Tensor
    Ux: torch.Tensor
    Uy: torch.Tensor
    r: torch.Tensor
    A: torch.Tensor
    delta: torch.Tensor
    Fxf: torch.Tensor
    Fxr: torch.Tensor


def trim(veh, V, A_tan, kappa, num_iters: int, r=None, beta0=None,
         delta0=None, Fyf0=None) -> Trim:
    """Steady-state trim for speed V, tangential acceleration A_tan and
    curvature kappa, the radial acceleration given priority on the
    friction circle (src/vehicle_dynamics.jl:318-390, with the inverse
    tire's unsaturated branch scaled as `inv_fiala`)."""
    z = torch.zeros_like(V)
    r = V * kappa if r is None else r
    beta = z if beta0 is None else beta0
    delta = z if delta0 is None else delta0
    Fyf = z if Fyf0 is None else Fyf0
    L, a, b, h, m, Izz, mu, G = (veh.L, veh.a, veh.b, veh.h, veh.m,
                                 veh.Izz, veh.mu, veh.G)
    fwd, rwd, fwb, rwb = veh.fwd_frac, veh.rwd_frac, veh.fwb_frac, \
        veh.rwb_frac
    A_rad = V * V * kappa
    A_max = mu * G
    over = torch.hypot(A_tan, A_rad) > A_max
    rad_over = torch.abs(A_rad) > A_max
    A_rad_c = torch.where(over & rad_over, A_max * torch.sign(A_rad), A_rad)
    A_tan = torch.where(over, torch.where(
        rad_over, torch.zeros_like(A_tan),
        torch.sqrt(maximum(A_max * A_max - A_rad * A_rad, 0.0))
        * torch.sign(A_tan)), A_tan)
    A_rad = A_rad_c
    r_dot = A_tan * kappa
    Fxf = Fxr = z
    for i in range(num_iters):
        s_b, c_b = torch.sin(beta), torch.cos(beta)
        s_d, c_d = torch.sin(delta), torch.cos(delta)
        Ux, Uy = V * c_b, V * s_b
        drag = _drag(veh, Ux)
        Ax = A_tan * c_b - A_rad * s_b
        Ay = A_tan * s_b + A_rad * c_b
        Fx = minimum(Ax * m - drag,
                     minimum(veh.Px_max / Ux, veh.Fx_max)
                     * (rwd + fwd * c_d) - Fyf * s_d)
        Fr_max = mu * (m * G * a + h * Fx) / L
        Ff_max = mu * (m * G * b - h * Fx) / L
        frac = torch.where(Fx > 0, rwd / (rwd + fwd * c_d),
                           rwb / (rwb + fwb * c_d))
        Fxr = minimum(maximum((Fx + Fyf * s_d) * frac, -Fr_max), Fr_max)
        Fyr_max = torch.sqrt(maximum(Fr_max * Fr_max - Fxr * Fxr, 0.0))
        Fyr = minimum(maximum((Ay * m - r_dot * Izz / a) / (1.0 + b / a),
                              -Fyr_max), Fyr_max)
        tan_ar = inv_fiala(Fyr, veh.Car, Fyr_max)
        Fxf_b = minimum(maximum(Fx - Fxr, -Ff_max), Ff_max)
        Fyf_b_max = torch.sqrt(maximum(Ff_max * Ff_max - Fxf_b * Fxf_b, 0.0))
        Fyf_b = minimum(maximum((b * Fyr + r_dot * Izz) / a, -Fyf_b_max),
                        Fyf_b_max)
        Fxf = Fxf_b * c_d + Fyf_b * s_d
        Fyf = Fyf_b * c_d - Fxf_b * s_d
        Fyf_max = torch.sqrt(maximum(Ff_max * Ff_max - Fxf * Fxf, 0.0))
        alpha_f = torch.atan(inv_fiala(Fyf, veh.Caf, Fyf_max))
        delta = torch.atan2(Uy + a * r, Ux) - alpha_f
        if i == num_iters - 1:
            # the last pass takes the trig of the delta before its update
            Ax = (Fxf * c_d - Fyf * s_d + Fxr + drag) / m
            Ay = (Fyf * c_d + Fxf * s_d + Fyr) / m
            A_tan = Ax * c_b + Ay * s_b
        else:
            beta = torch.atan(tan_ar + b * r / Ux)
    s_b, c_b = torch.sin(beta), torch.cos(beta)
    return Trim(beta=beta, Ux=V * c_b, Uy=V * s_b, r=r, A=A_tan,
                delta=delta, Fxf=Fxf, Fxr=Fxr)
