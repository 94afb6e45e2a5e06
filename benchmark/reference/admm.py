"""A plain OSQP-style ADMM for the reference's QPs: fixed rho (stiffer on
the rows with l == u), the KKT inverse from a Cholesky factor, OSQP's
relaxed iteration and its unscaled termination test every
`check_every` iterations.  Only the control (`benchmark/control.py`)
solves with it: the comparison judges the program's own solution."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from benchmark.reference.precision import Arith


class Solution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    iterations: torch.Tensor
    prim_res: torch.Tensor
    dual_res: torch.Tensor
    converged: torch.Tensor


def residuals(qp, x, y, z, eps_abs: float, eps_rel: float, ar: Arith,
              A=None):
    """(r_prim, r_dual, eps_prim, eps_dual) of each instance, unscaled;
    `A`, if given, is qp.A already rounded by `ar`."""
    A = ar.r(qp.A) if A is None else A
    Ax = (A @ ar.r(x)[..., None])[..., 0]
    Aty = (A.transpose(-1, -2) @ ar.r(y)[..., None])[..., 0]
    Px = qp.P * x
    amax = lambda v: v.abs().amax(-1)
    r_p = amax(Ax - z)
    r_d = amax(Px + qp.q + Aty)
    e_p = eps_abs + eps_rel * torch.maximum(amax(Ax), amax(z))
    e_d = eps_abs + eps_rel * torch.maximum(torch.maximum(amax(Px),
                                                          amax(Aty)),
                                            amax(qp.q))
    return r_p, r_d, e_p, e_d


def solve(qp, warm, opts: dict, ar: Arith) -> Solution:
    """Solve a batch of QPs from the warm start (x, y, z) with the
    configuration's solver options (rho, rho_eq_scale, sigma, alpha,
    eps_abs, eps_rel, max_iter, check_every)."""
    x, y, z = warm
    rho0, sigma, alpha = opts["rho"], opts["sigma"], opts["alpha"]
    eps_a, eps_r = opts["eps_abs"], opts["eps_rel"]
    rho = torch.where(qp.l == qp.u, rho0 * opts["rho_eq_scale"],
                      torch.full_like(qp.l, rho0))
    A = ar.r(qp.A)
    At = A.transpose(-1, -2)
    K = (ar.r(At * rho[:, None, :]) @ A) + torch.diag_embed(qp.P + sigma)
    # the factor itself in float64 (TF32 rounds products, not factors)
    K64 = K.double()
    L, info = torch.linalg.cholesky_ex(K64)
    if bool((info != 0).any()):
        jitter = 1e-9 * K64.diagonal(dim1=-2, dim2=-1).abs().amax(-1)
        L, info = torch.linalg.cholesky_ex(
            K64 + jitter[:, None, None] * torch.eye(
                K.shape[-1], dtype=K64.dtype, device=K.device))
    # an instance whose K has no factor (non-finite QP data) gets a
    # non-finite solution
    L = torch.where((info != 0)[:, None, None], math.nan, L)
    Kinv = ar.r(torch.cholesky_inverse(L).to(K.dtype))
    del K, K64, L
    mv = lambda M, v: (M @ ar.r(v)[..., None])[..., 0]
    B = x.shape[0]
    iters = torch.zeros(B, dtype=torch.int32, device=x.device)
    conv = torch.zeros(B, dtype=torch.bool, device=x.device)
    r_p = r_d = torch.full((B,), float("inf"), dtype=x.dtype,
                           device=x.device)
    for it in range(1, opts["max_iter"] + 1):
        live = ~conv
        xt = mv(Kinv, sigma * x - qp.q + mv(At, rho * z - y))
        zt = mv(A, xt)
        xn = alpha * xt + (1.0 - alpha) * x
        zr = alpha * zt + (1.0 - alpha) * z
        zn = torch.minimum(torch.maximum(zr + y / rho, qp.l), qp.u)
        yn = y + rho * (zr - zn)
        x = torch.where(live[:, None], xn, x)
        z = torch.where(live[:, None], zn, z)
        y = torch.where(live[:, None], yn, y)
        iters = iters + live.to(torch.int32)
        if it % opts["check_every"] == 0 or it == opts["max_iter"]:
            rp, rd, ep, ed = residuals(qp, x, y, z, eps_a, eps_r, ar, A)
            r_p = torch.where(live, rp, r_p)
            r_d = torch.where(live, rd, r_d)
            conv = conv | ((rp <= ep) & (rd <= ed))
            if bool(conv.all()):
                break
    return Solution(x, y, z, iters, r_p, r_d, conv)
