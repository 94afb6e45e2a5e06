"""HJI reachability safety filter.  Counterpart of `pigeon_tpu/hji.py`
(the reference's `src/HJI_computation.jl`): 7-D relative state between the
ego bicycle and a "human" simple car, a value function V and gradient on a
7-D grid with multilinear interpolation (+inf outside the grid), relative
dynamics, analytic optimal disturbance, sampled optimal ego control, and
the least-restrictive half-plane constraint injected into the coupled QP.

Every function takes a leading batch of any shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch.config import VehicleParams
from pigeon_tpu_torch.math_utils import adiff

# Relative state components: (dE, dN, dpsi, Ux, Uy, V, r), where dE/dN are
# the human's position in the ego body frame (longitudinal, lateral).


class HJICache(NamedTuple):
    knots: tuple          # 7 float32 tensors of grid knots
    V: torch.Tensor       # flat (prod(dims),) float32
    gradV: "torch.Tensor | None"   # component-major (7, prod(dims)); None =
    #                                V-only cache (zero gradients)
    dims: tuple           # grid shape
    strides: tuple        # row-major strides


def make_cache(knots, V_grid, gradV_grid=None, device=None) -> HJICache:
    """Cache from numpy grids: V (dims), gradV (dims + (7,)) or None."""
    device = resolve_device(device)
    dims = tuple(int(np.shape(k)[0]) for k in knots)
    strides = tuple(int(np.prod(dims[i + 1:], dtype=np.int64))
                    for i in range(7))
    f32 = dict(dtype=torch.float32, device=device)
    g = None
    if gradV_grid is not None:
        g = torch.as_tensor(np.ascontiguousarray(
            np.asarray(gradV_grid, np.float32).reshape(-1, 7).T), **f32)
    return HJICache(
        knots=tuple(torch.as_tensor(np.asarray(k, np.float32), **f32)
                    for k in knots),
        V=torch.as_tensor(np.asarray(V_grid, np.float32).reshape(-1), **f32),
        gradV=g, dims=dims, strides=strides)


def inactive_cache(value: float = 1e9, device=None) -> HJICache:
    """Constant-V cache that never activates the filter (the reference's
    placeholder for the no-asset configuration, with V large)."""
    knots = [np.array([-1e3, 1e3], np.float32) for _ in range(7)]
    V = np.full((2,) * 7, value, np.float32)
    g = np.zeros((2,) * 7 + (7,), np.float32)
    return make_cache(knots, V, g, device=device)


_CORNERS = np.array([[(c >> i) & 1 for i in range(6, -1, -1)]
                     for c in range(128)], np.int64)   # (128, 7)


def interpolate(cache: HJICache, x):
    """Multilinear interpolation of (V, gradV) at x (..., 7); +inf and a
    zero gradient outside the grid."""
    x = x.to(cache.V.dtype)
    idx, frac = [], []
    inside = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    for i in range(7):
        k = cache.knots[i]
        xi = x[..., i].contiguous()
        j = torch.clamp(torch.searchsorted(k, xi, right=False) - 1,
                        0, cache.dims[i] - 2)
        idx.append(j)
        frac.append((xi - k[j]) / (k[j + 1] - k[j]))
        inside = inside & (xi >= k[0]) & (xi <= k[-1])
    idx = torch.stack(idx, dim=-1)                  # (..., 7)
    frac = torch.stack(frac, dim=-1)                # (..., 7)
    corners = torch.as_tensor(_CORNERS, device=x.device)
    strides = torch.as_tensor(cache.strides, device=x.device)
    flat = torch.sum((idx[..., None, :] + corners) * strides, dim=-1)
    f = frac[..., None, :]
    w = torch.prod(torch.where(corners == 1, f, 1.0 - f), dim=-1)  # (...,128)
    V = torch.sum(w * cache.V[flat], dim=-1)
    if cache.gradV is None:
        g = torch.zeros(x.shape[:-1] + (7,), dtype=V.dtype, device=x.device)
    else:
        g = torch.movedim(torch.sum(w * cache.gradV[:, flat], dim=-1), 0, -1)
    V = torch.where(inside, V, torch.full_like(V, torch.inf))
    g = torch.where(inside[..., None], g, torch.zeros_like(g))
    return V, g


def relative_state(ego_q6, them):
    """Ego bicycle state + simple-car state (E, N, psi, V) -> 7-D relative
    state (reference HJIRelativeState constructor)."""
    dE = them[..., 0] - ego_q6[..., 0]
    dN = them[..., 1] - ego_q6[..., 1]
    psi = ego_q6[..., 2]
    s, c = torch.sin(psi), torch.cos(psi)
    lon = -s * dE + c * dN
    lat = -c * dE - s * dN
    return torch.stack([
        lon, lat, adiff(them[..., 2], psi),
        ego_q6[..., 3], ego_q6[..., 4], them[..., 3], ego_q6[..., 5],
    ], dim=-1)


def relative_dynamics(veh: VehicleParams, x7, uR, uH):
    """Relative-state ODE; uR = (delta, Fx) ego, uH = (omega, a) human."""
    dE, dN, dpsi, Ux, Uy, V, r = (x7[..., i] for i in range(7))
    q6 = torch.stack([dE, dN, dpsi, Ux, Uy, r], dim=-1)
    bd = dyn.vehicle_ode(veh, "bicycle", q6, uR,
                         x7.new_zeros(x7.shape[:-1] + (4,)))
    s, c = torch.sin(dpsi), torch.cos(dpsi)
    omega, a = uH[..., 0], uH[..., 1]
    return torch.stack([
        V * c - Ux + dN * r,
        V * s - Uy - dE * r,
        omega - r,
        bd[..., 3], bd[..., 4],
        a,
        bd[..., 5],
    ], dim=-1)


def optimal_disturbance(veh: VehicleParams, x7, gradV, d_mode: str = "min"):
    """Analytic worst/best-case human control (omega, a), the reference's
    branch tree as nested `where`s."""
    sgn = 1.0 if d_mode == "max" else -1.0
    V = torch.clamp(x7[..., 5], min=0.1)
    kappa_max = veh.kappa_max
    Ax_max = veh.Fx_max / veh.m
    Pmx_max = veh.Px_max / veh.m
    maxA = 0.9 * veh.mu * veh.G

    lam_w = gradV[..., 2]
    lam_Ax = gradV[..., 5]
    lam_Ay = lam_w / V
    lam_norm = torch.hypot(lam_Ax, lam_Ay)
    safe_norm = torch.clamp(lam_norm, min=1e-12)

    desAx = sgn * lam_Ax * maxA / safe_norm
    desAy = sgn * lam_Ay * maxA / safe_norm
    maxAx = torch.clamp(Pmx_max / V, max=Ax_max)
    maxAy = kappa_max * V * V

    # branch 1: desired Ax exceeds the drive limit
    maxAy_1 = torch.where(
        torch.abs(desAy) < maxAy,
        torch.minimum(maxAy, torch.sqrt(torch.clamp(
            maxA * maxA - maxAx * maxAx, min=0.0))),
        maxAy)
    out1 = torch.stack([torch.copysign(maxAy_1, desAy) / V, maxAx], dim=-1)
    # branch 2: |desAy| exceeds the curvature limit
    rad = torch.sqrt(torch.clamp(maxA * maxA - maxAy * maxAy, min=0.0))
    out2 = torch.stack([
        torch.copysign(maxAy, desAy) / V,
        torch.where(desAx > 0, torch.minimum(rad, maxAx), -rad),
    ], dim=-1)
    # branch 3: interior
    out3 = torch.stack([desAy / V, maxAx], dim=-1)

    out = torch.where((desAx > maxAx)[..., None], out1,
                      torch.where((torch.abs(desAy) > maxAy)[..., None],
                                  out2, out3))
    return torch.where((lam_norm < 1e-3)[..., None], torch.zeros_like(out),
                       out)


def optimal_control(veh: VehicleParams, x7, gradV, u_mode: str = "max",
                    n_samples: int = 50):
    """Bang-bang steering + Fx line search maximizing the Hamiltonian;
    a running max over the Fx samples with first-max ties, as argmax."""
    sgn = 1.0 if u_mode == "max" else -1.0
    A = gradV[..., 3] / veh.m
    B = gradV[..., 4] / veh.m + veh.a * gradV[..., 6] / veh.Izz
    C = gradV[..., 4] / veh.m - veh.b * gradV[..., 6] / veh.Izz
    delta_opt = torch.where(B >= 0, torch.full_like(B, sgn * veh.delta_max),
                            torch.full_like(B, -sgn * veh.delta_max))

    fracs = torch.arange(n_samples, dtype=x7.dtype,
                         device=x7.device) / (n_samples - 1)
    Fx_grid = fracs * veh.Fx_max + (1.0 - fracs) * veh.Fx_min

    Ux, Uy, r = x7[..., 3], x7[..., 4], x7[..., 6]

    def ham(Fx):
        Fx = torch.broadcast_to(Fx, delta_opt.shape)
        Fxf, Fxr = dyn.longitudinal_split(veh, Fx)
        u3 = torch.stack([delta_opt, Fxf, Fxr], dim=-1)
        Fyf, Fyr = dyn.lateral_tire_forces(veh, Ux, Uy, r, u3)
        return A * Fx + B * Fyf + C * Fyr

    best_val = sgn * ham(Fx_grid[0])
    best_Fx = torch.broadcast_to(Fx_grid[0], best_val.shape)
    for k in range(1, n_samples):
        v = sgn * ham(Fx_grid[k])
        better = v > best_val
        best_val = torch.where(better, v, best_val)
        best_Fx = torch.where(better, Fx_grid[k], best_Fx)
    return torch.stack([delta_opt, best_Fx], dim=-1)


def reachability_constraint(veh: VehicleParams, cache: HJICache, x7,
                            eps: float, u_lin=None):
    """Least-restrictive half-plane M.u + b >= 0 on the ego control,
    linearized at u_lin; inactive (M=0, b=1) where V(x) > eps.  The
    Hamiltonian's gradient in u is `torch.func.grad` of its batch sum
    (each instance's value depends on its own control only)."""
    V, gradV = interpolate(cache, x7)
    gradV = gradV.to(x7.dtype)
    if u_lin is None:
        u_lin = optimal_control(veh, x7, gradV)
    uH = optimal_disturbance(veh, x7, gradV)

    def ham(uR):
        h = torch.sum(gradV * relative_dynamics(veh, x7, uR, uH), dim=-1)
        return h.sum(), h

    M_act, h = torch.func.grad(ham, has_aux=True)(u_lin)
    b_act = h - torch.sum(M_act * u_lin, dim=-1)

    active = V <= eps
    M = torch.where(active[..., None], M_act, torch.zeros_like(M_act))
    b = torch.where(active, b_act, torch.ones_like(b_act))
    return M, b, V, gradV


# ---------------------------------------------------------------------------
# Synthetic value function (the no-asset stand-in of the JAX package)
# ---------------------------------------------------------------------------

def _analytic_value(x7, margin: float = 3.0, horizon: float = 1.0):
    """Smooth collision-proximity surrogate of one relative state (7,):
    the soft minimum of the predicted separation (constant-velocity
    extrapolation over `horizon`) minus a margin."""
    dE, dN, dpsi, Ux, Uy, V, r = x7.unbind(-1)
    rvx = V * torch.cos(dpsi) - Ux
    rvy = V * torch.sin(dpsi) - Uy
    taus = torch.linspace(0.0, horizon, 8, dtype=x7.dtype, device=x7.device)
    d2 = (dE + rvx * taus) ** 2 + (dN + rvy * taus) ** 2
    dmin = -torch.logsumexp(-torch.sqrt(d2 + 1e-6) * 2.0, dim=-1) / 2.0
    return dmin - margin


def synthetic_cache(n_per_dim: int = 5, device=None) -> HJICache:
    """A coarse 7-D grid of `_analytic_value` and its gradient, computed
    in float64 on the host (`torch.func.grad` under `vmap`), then stored
    as `make_cache` stores any grid."""
    knots = [
        np.linspace(-20.0, 20.0, n_per_dim),    # dE
        np.linspace(-20.0, 20.0, n_per_dim),    # dN
        np.linspace(-np.pi, np.pi, n_per_dim),  # dpsi
        np.linspace(1.0, 20.0, n_per_dim),      # Ux
        np.linspace(-3.0, 3.0, n_per_dim),      # Uy
        np.linspace(0.0, 20.0, n_per_dim),      # V
        np.linspace(-1.5, 1.5, n_per_dim),      # r
    ]
    grids = np.meshgrid(*knots, indexing="ij")
    pts = torch.as_tensor(np.stack([g.ravel() for g in grids], axis=-1),
                          dtype=torch.float64)
    V = torch.func.vmap(_analytic_value)(pts).numpy()
    G = torch.func.vmap(torch.func.grad(_analytic_value))(pts).numpy()
    return make_cache(knots, V.reshape([n_per_dim] * 7),
                      G.reshape([n_per_dim] * 7 + [7]), device=device)
