"""The HJI safety row: the relative state to the other car, the value
function's multilinear interpolation on its 7-D grid with the gradient
field of central differences (one-sided halves at the edges), the
worst-case other car and the least-restrictive half-plane on the ego
control, linearized at the command in effect (Pigeon.jl's HJI filter).

`Grid` reads a value grid's file itself (V and the knots of an npz) or
stands for the grid that never binds; the gradient is worked out from V
at the cells a query touches.  `row` also says where a float32 run may
decide a branch the other way: the value within rounding of eps, the
heading difference on the +-pi wrap, a point on the grid's edge, the
other car's control within rounding of one of its branches, or (as a
row's value, not a branch) the command it is linearized at braking an
axle on its friction circle.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import vehicle as vh

_CORNERS = torch.tensor([[(c >> i) & 1 for i in range(6, -1, -1)]
                         for c in range(128)])   # (128, 7)
# |V - eps| and branch margins inside which float32 may choose otherwise
V_BAND = 1e-4
BRANCH_BAND = 1e-4
WRAP_BAND = 1e-4


class Grid:
    """Knots (7 tensors) and V (flat, row-major) in `dtype`; `inactive`
    is the 2^7 grid on [-1e3, 1e3] with V = 1e9 everywhere."""

    def __init__(self, path: "str | None", dtype=torch.float64,
                 device="cpu"):
        if path is None:
            knots = [np.array([-1e3, 1e3])] * 7
            V = np.full((2,) * 7, 1e9)
        else:
            with np.load(path) as d:
                knots = [d[f"knots_{i}"] for i in range(7)]
                V = d["V"]
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float64),
                                         dtype=dtype, device=device)
        self.knots = [as_t(k) for k in knots]
        self.dims = tuple(len(k) for k in knots)
        self.strides = tuple(int(np.prod(self.dims[i + 1:], dtype=np.int64))
                             for i in range(7))
        self.V = as_t(np.asarray(V).reshape(-1))
        self.h = [float(k[1] - k[0]) for k in knots]

    def _grad_at(self, idx):
        """Central-difference gradient (7 components) at grid points idx
        (..., 7), one-sided halves at the edges."""
        st = torch.as_tensor(self.strides, device=idx.device)
        flat = lambda j: (j * st).sum(-1)
        g = []
        for ax in range(7):
            up, dn = idx.clone(), idx.clone()
            up[..., ax] = torch.clamp(idx[..., ax] + 1, max=self.dims[ax] - 1)
            dn[..., ax] = torch.clamp(idx[..., ax] - 1, min=0)
            g.append((self.V[flat(up)] - self.V[flat(dn)])
                     / (2.0 * self.h[ax]))
        return torch.stack(g, dim=-1)

    def interpolate(self, x):
        """(V, gradV) at x (..., 7); +inf and 0 outside the grid."""
        idx, frac = [], []
        inside = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
        for i in range(7):
            k, xi = self.knots[i], x[..., i].contiguous()
            j = torch.clamp(torch.searchsorted(k, xi) - 1, 0,
                            self.dims[i] - 2)
            idx.append(j)
            frac.append((xi - k[j]) / (k[j + 1] - k[j]))
            inside = inside & (xi >= k[0]) & (xi <= k[-1])
        idx = torch.stack(idx, -1)[..., None, :] + _CORNERS.to(x.device)
        f = torch.stack(frac, -1)[..., None, :]
        w = torch.prod(torch.where(_CORNERS.to(x.device) == 1, f, 1.0 - f),
                       dim=-1)                                  # (..., 128)
        st = torch.as_tensor(self.strides, device=x.device)
        V = (w * self.V[(idx * st).sum(-1)]).sum(-1)
        g = (w[..., None] * self._grad_at(idx)).sum(-2)
        V = torch.where(inside, V, torch.full_like(V, math.inf))
        g = torch.where(inside[..., None], g, torch.zeros_like(g))
        return V, g


def adiff(a, b):
    d = a - b
    return d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))


def relative_state(q, other):
    """(dE, dN) of the other car in the ego frame, the heading
    difference, Ux, Uy, the other car's speed and r."""
    dE, dN = other[..., 0] - q[..., 0], other[..., 1] - q[..., 1]
    s, c = torch.sin(q[..., 2]), torch.cos(q[..., 2])
    return torch.stack([-s * dE + c * dN, -c * dE - s * dN,
                        adiff(other[..., 2], q[..., 2]), q[..., 3],
                        q[..., 4], other[..., 3], q[..., 5]], dim=-1)


def relative_dynamics(veh, x, uR, uH, ties):
    dE, dN, dpsi, Ux, Uy, V, r = x.unbind(-1)
    q6 = torch.stack([dE, dN, dpsi, Ux, Uy, r], dim=-1)
    bd = vh.ode(veh, "bicycle", q6, uR, None, ties)
    return torch.stack([V * torch.cos(dpsi) - Ux + dN * r,
                        V * torch.sin(dpsi) - Uy - dE * r,
                        uH[..., 0] - r, bd[..., 3], bd[..., 4], uH[..., 1],
                        bd[..., 5]], dim=-1)


def disturbance(veh, x, g):
    """The other car's control (omega, a) that lowers V fastest, and the
    margins of its branches (how far each test is from flipping)."""
    V = torch.clamp(x[..., 5], min=0.1)
    Ax_max, Pmx_max = veh.Fx_max / veh.m, veh.Px_max / veh.m
    maxA = 0.9 * veh.mu * veh.G
    lam_w, lam_Ax = g[..., 2], g[..., 5]
    lam_Ay = lam_w / V
    lam_norm = torch.hypot(lam_Ax, lam_Ay)
    safe = torch.clamp(lam_norm, min=1e-12)
    desAx, desAy = -lam_Ax * maxA / safe, -lam_Ay * maxA / safe
    maxAx = torch.clamp(Pmx_max / V, max=Ax_max)
    maxAy = veh.kappa_max * V * V
    maxAy_1 = torch.where(torch.abs(desAy) < maxAy, torch.minimum(
        maxAy, torch.sqrt(torch.clamp(maxA * maxA - maxAx * maxAx, min=0.0))),
        maxAy)
    out1 = torch.stack([torch.copysign(maxAy_1, desAy) / V, maxAx], -1)
    rad = torch.sqrt(torch.clamp(maxA * maxA - maxAy * maxAy, min=0.0))
    out2 = torch.stack([torch.copysign(maxAy, desAy) / V,
                        torch.where(desAx > 0, torch.minimum(rad, maxAx),
                                    -rad)], -1)
    out3 = torch.stack([desAy / V, maxAx], -1)
    out = torch.where((desAx > maxAx)[..., None], out1, torch.where(
        (torch.abs(desAy) > maxAy)[..., None], out2, out3))
    out = torch.where((lam_norm < 1e-3)[..., None], torch.zeros_like(out),
                      out)
    rel = lambda a, b: (a - b).abs() / torch.clamp(b.abs(), min=1.0)
    margin = torch.stack([rel(desAx, maxAx), rel(desAy.abs(), maxAy),
                          rel(lam_norm, torch.full_like(lam_norm, 1e-3)),
                          desAx.abs() / maxA, desAy.abs() / maxA], -1)
    return out, margin.amin(-1)


def row(veh, grid: Grid, q, other, u3_prev, eps: float, ties):
    """(M, b, V, gradV, x, ambiguous): the half-plane M.u + b >= 0 on the
    physical (delta, Fx), linearized at the command in effect, where V
    <= eps (M = 0, b = 1 elsewhere)."""
    x = relative_state(q, other)
    V, g = grid.interpolate(x)
    uH, margin = disturbance(veh, x, g)
    u_lin = torch.stack([u3_prev[..., 0], u3_prev[..., 1] + u3_prev[..., 2]],
                        -1)

    def ham(uR):
        h = (g * relative_dynamics(veh, x, uR, uH, ties)).sum(-1)
        return h.sum(), h

    M, h = torch.func.grad(ham, has_aux=True)(u_lin)
    b = h - (M * u_lin).sum(-1)
    active = V <= eps
    wrap = (x[..., 2].abs() - math.pi).abs() <= WRAP_BAND
    edge = torch.zeros_like(active)
    for i, k in enumerate(grid.knots):
        near = lambda e: (x[..., i] - e).abs() <= WRAP_BAND * max(
            1.0, abs(float(e)))
        edge = edge | near(k[0]) | near(k[-1])
    Fx_lin = vh.control_limits(veh, u_lin, q[..., 3])[..., 1]
    ambiguous = (((V - eps).abs() <= V_BAND)
                 | (torch.isfinite(V) & (wrap | edge))
                 | (active & ((margin <= BRANCH_BAND) | (
                     vh.friction_margin(veh, Fx_lin) <= vh.FRICTION_BAND))))
    M = torch.where(active[..., None], M, torch.zeros_like(M))
    b = torch.where(active, b, torch.ones_like(b))
    return M, b, V, g, x, ambiguous
