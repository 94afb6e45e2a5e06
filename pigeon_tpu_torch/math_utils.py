"""Small math utilities (reference: `src/math.jl:1-9` and
`DifferentialDynamicsModels.adiff/mod2piF`).  Counterpart of
`pigeon_tpu/math_utils.py`; every function broadcasts over leading
dimensions."""

from __future__ import annotations

import math

import torch


def minimum(x, y):
    """Elementwise minimum, `y` a tensor or a number.  Its forward-mode
    derivative at a tie is half from each side, as JAX's `jnp.minimum`
    (torch.clamp passes the whole derivative of one side); the trim
    estimator saturates forces exactly at their limits, so ties occur on
    the linearization path."""
    return torch.minimum(x, y if isinstance(y, torch.Tensor)
                         else torch.full_like(x, y))


def maximum(x, y):
    """Elementwise maximum with JAX's tie derivative (see `minimum`)."""
    return torch.maximum(x, y if isinstance(y, torch.Tensor)
                         else torch.full_like(x, y))


def clip(x, lo, hi):
    """`jnp.clip`: minimum(maximum(x, lo), hi), JAX's tie derivatives."""
    return minimum(maximum(x, lo), hi)


def cumtrapz(y, x, x0=0.0):
    """Cumulative trapezoid integral of y dx (reference: `src/math.jl:1`)."""
    y = torch.as_tensor(y)
    x = torch.as_tensor(x)
    inc = torch.diff(x) * (y[:-1] + y[1:]) / 2.0
    return torch.cat([inc.new_zeros(1), torch.cumsum(inc, 0)]) + x0


def invcumtrapz(y, x, x0=0.0):
    """Cumulative integral of dx/y — e.g. reconstruct time from speed-vs-
    arclength (reference: `src/math.jl:2`)."""
    y = torch.as_tensor(y)
    x = torch.as_tensor(x)
    inc = 2.0 * torch.diff(x) / (y[:-1] + y[1:])
    return torch.cat([inc.new_zeros(1), torch.cumsum(inc, 0)]) + x0


def segment_distance2(p0, p1, x):
    """Squared distance from point(s) x to segment(s) [p0, p1].

    p0, p1, x have shape (..., 2); broadcasting applies.
    Returns (d2, lam) where lam in [0,1] is the projection parameter.
    """
    v = p1 - p0
    w = x - p0
    vv = torch.sum(v * v, dim=-1)
    lam = torch.clamp(torch.sum(v * w, dim=-1)
                      / torch.where(vv > 0, vv, torch.ones_like(vv)), 0.0, 1.0)
    p = p0 + lam[..., None] * v
    d = p - x
    return torch.sum(d * d, dim=-1), lam


def adiff(a, b):
    """Angular difference a - b wrapped to (-pi, pi]
    (reference: `DifferentialDynamicsModels.adiff`)."""
    d = a - b
    return d - 2.0 * math.pi * torch.round(d / (2.0 * math.pi))


def cross2(v, w):
    """2-D cross product z-component (sign of the lateral path error,
    reference `src/trajectories.jl:84`)."""
    return v[..., 0] * w[..., 1] - v[..., 1] * w[..., 0]
