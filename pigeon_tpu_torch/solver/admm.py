"""OSQP-style QP containers, cold start and Ruiz equilibration, batched
over a leading instance dimension.  Counterpart of the part of
`pigeon_tpu/solver/admm.py` that the lane solver uses (admm.py:42-135).

Canonical form: minimize 1/2 x'Px + q'x subject to l <= Ax <= u, with P a
dense (..., n, n) Hessian or a (..., n) diagonal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

RHO_MIN, RHO_MAX = 1e-6, 1e6


class QPData(NamedTuple):
    P_diag: torch.Tensor  # (B, n) diagonal | (B, n, n) dense
    q: torch.Tensor       # (B, n)
    A: torch.Tensor       # (B, m, n)
    l: torch.Tensor       # (B, m)
    u: torch.Tensor       # (B, m)


class QPWarmStart(NamedTuple):
    x: torch.Tensor       # (B, n)
    y: torch.Tensor       # (B, m) dual
    z: torch.Tensor       # (B, m) constraint-space iterate
    rho_scale: "torch.Tensor | None" = None   # (B,) adapted rho multiplier


class QPSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    iterations: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    converged: torch.Tensor
    rho_scale: torch.Tensor


def cold_start(qp: QPData) -> QPWarmStart:
    z = torch.zeros_like(qp.l)
    return QPWarmStart(x=torch.zeros_like(qp.q), y=z, z=z,
                       rho_scale=torch.ones_like(qp.q[..., 0]))


def ruiz(qp: QPData, iters: int):
    """Modified Ruiz equilibration of [[P, A'], [A, 0]] plus cost scaling
    (OSQP semantics), per instance.  Returns the scaled problem and the
    scalings (D, E, c): x = D x_bar, rows scaled by E, objective by c.
    Zero-norm rows and columns stay unscaled."""
    P, q, A, l, u = qp
    dense_P = P.dim() == q.dim() + 1
    D = torch.ones_like(q)
    E = torch.ones_like(l)
    c = torch.ones_like(q[..., 0])
    eps = 1e-12
    absA = torch.abs(A)
    absP = torch.abs(P).amax(dim=-1) if dense_P else torch.abs(P)
    absq = torch.abs(q)
    one = torch.ones((), dtype=q.dtype, device=q.device)
    for _ in range(iters):
        Ps = absP * D * D * c[..., None]
        col_x = torch.maximum(Ps, (absA * E[..., :, None]).amax(dim=-2) * D)
        col_y = (absA * D[..., None, :]).amax(dim=-1) * E
        D = D / torch.sqrt(torch.where(col_x <= eps, one,
                                       torch.clamp(col_x, min=eps)))
        E = E / torch.sqrt(torch.where(col_y <= eps, one,
                                       torch.clamp(col_y, min=eps)))
        Ps = absP * D * D * c[..., None]
        qs = c[..., None] * D * absq
        g = torch.maximum(Ps.mean(dim=-1), qs.amax(dim=-1))
        c = c / torch.clamp(g, min=1.0)
    if dense_P:
        Pb = c[..., None, None] * (D[..., :, None] * P * D[..., None, :])
    else:
        Pb = P * D * D * c[..., None]
    qb = c[..., None] * D * q
    Ab = (E[..., :, None] * A) * D[..., None, :]
    return QPData(Pb, qb, Ab, E * l, E * u), D, E, c
