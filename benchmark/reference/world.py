"""The path the fleet follows, and lookups on it.

`oval_columns` is the world of every configuration here: one lap of a
closed oval at constant speed (a straight along +N, a left semicircle, a
straight back and a second semicircle; 983 knots), as numpy columns.  The
harness hands these columns to the program and to `Path` alike.  `Path`
holds the live knots in the reference's dtype and samples them as
Pigeon.jl's trajectory does: constant acceleration between time knots,
linear interpolation of the spatial columns, linear extrapolation past
the ends, and projection onto the nearest segment.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def oval_columns(straight: float = 60.0, radius: float = 20.0,
                 speed: float = 8.0, spacing: float = 0.25) -> dict:
    arc = math.pi * radius
    s = np.arange(0.0, 2.0 * (straight + arc) + 1e-9, spacing)
    E, N, psi = np.empty_like(s), np.empty_like(s), np.empty_like(s)
    kappa = np.zeros_like(s)
    seg1 = s < straight
    seg2 = (s >= straight) & (s < straight + arc)
    seg3 = (s >= straight + arc) & (s < 2 * straight + arc)
    seg4 = s >= 2 * straight + arc
    E[seg1], N[seg1], psi[seg1] = 0.0, s[seg1], 0.0
    th = (s[seg2] - straight) / radius
    E[seg2] = -radius + radius * np.cos(th)
    N[seg2] = straight + radius * np.sin(th)
    psi[seg2] = th
    kappa[seg2] = 1.0 / radius
    back = s[seg3] - straight - arc
    E[seg3], N[seg3], psi[seg3] = -2.0 * radius, straight - back, math.pi
    th = (s[seg4] - 2 * straight - arc) / radius
    E[seg4] = -radius - radius * np.cos(th)
    N[seg4] = -radius * np.sin(th)
    psi[seg4] = math.pi + th
    kappa[seg4] = 1.0 / radius
    n = s.shape[0]
    return dict(t=s / speed, s=s, V=np.full(n, speed), A=np.zeros(n), E=E,
                N=N, psi=psi, kappa=kappa)


WORLDS = {"oval": oval_columns}

_SPATIAL = ("E", "N", "psi", "kappa", "edge_L", "edge_R")
# squared distances (m^2) within which float32 may pick the other segment
PROJECT_BAND = 1e-5


class Path:
    """Live knots of a path's columns (t, s, V, E, N, psi, kappa and the
    lane edges, +-4 m where the columns give none)."""

    def __init__(self, cols: dict, dtype=torch.float64, device="cpu"):
        n = len(cols["t"])
        full = dict(cols)
        full.setdefault("edge_L", np.full(n, 4.0))
        full.setdefault("edge_R", np.full(n, -4.0))
        self.n = n
        self.col = {k: torch.as_tensor(np.asarray(full[k], np.float64),
                                       dtype=dtype, device=device)
                    for k in ("t", "s", "V") + _SPATIAL}

    def _segment(self, knots, x):
        i = torch.searchsorted(knots, x.contiguous(), right=True) - 1
        return torch.clamp(i, 0, self.n - 2)

    def _spatial(self, i, lam):
        c = self.col
        return {k: c[k][i] + lam * (c[k][i + 1] - c[k][i])
                for k in _SPATIAL}

    def at_time(self, t) -> dict:
        """s, V, A and the spatial columns at time t."""
        c = self.col
        i = self._segment(c["t"], t)
        t0, s0, V0 = c["t"][i], c["s"][i], c["V"][i]
        A = (c["V"][i + 1] - V0) / (c["t"][i + 1] - t0)
        dt = t - t0
        s = s0 + V0 * dt + A * dt * dt / 2.0
        out = self._spatial(i, (s - s0) / (c["s"][i + 1] - s0))
        out.update(s=s, V=V0 + A * dt, A=A)
        return out

    def at_arclength(self, s) -> dict:
        """t, V, A and the spatial columns at arclength s."""
        c = self.col
        i = self._segment(c["s"], s)
        t0, s0, V0 = c["t"][i], c["s"][i], c["V"][i]
        ds = s - s0
        A = (c["V"][i + 1] - V0) / (c["t"][i + 1] - t0)
        dt = self._dt_on(A, V0, ds, s)
        out = self._spatial(i, ds / (c["s"][i + 1] - s0))
        out.update(t=t0 + dt, V=V0 + A * dt, A=A)
        return out

    def _dt_on(self, A, V0, ds, s):
        """Time to cover ds from speed V0 at constant A (linear where A
        is nearly 0 or past the last knot)."""
        disc = torch.sqrt(torch.clamp(2.0 * A * ds + V0 * V0, min=0.0))
        linear = (torch.abs(A) < 1e-3) | (s > self.col["s"][-1])
        A_safe = torch.where(torch.abs(A) < 1e-3, torch.ones_like(A), A)
        return torch.where(linear, ds / V0, (disc - V0) / A_safe)

    def project(self, xy, near_s=None):
        """(s, e) of world points xy (..., 2): the nearest point of the
        polyline (first of equals), e positive to the left.  On the
        inside of a bend the nearest segment changes at each knot's
        bisector, where s jumps by e times the bend between segments;
        with `near_s`, where the two nearest segments lie within
        PROJECT_BAND of each other, the one whose s is nearer `near_s`.
        Also returns how many points took the second segment."""
        c = self.col
        p = torch.stack([c["E"], c["N"]], dim=-1)
        p0, p1 = p[:-1], p[1:]
        v = p1 - p0
        w = xy[..., None, :] - p0
        vv = (v * v).sum(-1)
        lam = torch.clamp((v * w).sum(-1) / vv, 0.0, 1.0)
        d = p0 + lam[..., None] * v - xy[..., None, :]
        d2 = (d * d).sum(-1)
        two, idx = torch.topk(d2, 2, dim=-1, largest=False, sorted=True)

        def on(i, d2min):
            wi, vi = xy - p0[i], v[i]
            ds = torch.sqrt(torch.clamp((wi * wi).sum(-1) - d2min, min=0.0))
            cross = vi[..., 0] * wi[..., 1] - vi[..., 1] * wi[..., 0]
            return c["s"][i] + ds, torch.sqrt(d2min) * torch.sign(cross)

        # the first of equals, as an argmin takes it
        first = torch.where(two[..., 1] == two[..., 0],
                            torch.minimum(idx[..., 0], idx[..., 1]),
                            idx[..., 0])
        second = torch.where(first == idx[..., 0], idx[..., 1], idx[..., 0])
        s, e = on(first, two[..., 0])
        if near_s is None:
            return s, e, 0
        s2, e2 = on(second, two[..., 1])
        close = (two[..., 1] - two[..., 0]) <= PROJECT_BAND * (
            1.0 + two[..., 0])
        take = close & ((s2 - near_s).abs() < (s - near_s).abs())
        return (torch.where(take, s2, s), torch.where(take, e2, e),
                int(take.sum()))
