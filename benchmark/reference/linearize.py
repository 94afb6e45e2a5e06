"""Exact discretization of a horizon's stages: linearize the continuous
dynamics at each node (forward-mode derivatives), then take the matrix
exponential of the augmented stage matrix, with the input held over a
short stage (ZOH) and ramping to the next node's over a long one (FOH).

The exponential is scaling and squaring with a Taylor sum of order 14
after scaling to norm 1/4 or less: exact to float64 rounding.  Every
matrix product goes through the `Arith` the caller passes.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.precision import Arith

TAYLOR_ORDER = 14


def expm(M: torch.Tensor, ar: Arith) -> torch.Tensor:
    """exp(M) of a batch (..., d, d)."""
    norm = float(M.abs().sum(-2).amax()) if M.numel() else 0.0
    sq = max(0, math.ceil(math.log2(norm / 0.25))) if norm > 0.25 else 0
    X = M / (2.0 ** sq)
    eye = torch.eye(M.shape[-1], dtype=M.dtype, device=M.device)
    E = eye.expand_as(M)
    term = E
    for j in range(1, TAYLOR_ORDER + 1):
        term = ar.mm(term, X) / j
        E = E + term
    for _ in range(sq):
        E = ar.mm(E, E)
    return E


def jacobians(f, q, ur):
    """Jq (K, n, n) and Ju (K, n, m) of the row-wise f(q (K, n), ur (K,
    m)) -> (K, n), one forward-mode pass per input column."""
    cols = []
    for which, a in ((0, q), (1, ur)):
        for j in range(a.shape[-1]):
            tq, tu = torch.zeros_like(q), torch.zeros_like(ur)
            (tq if which == 0 else tu)[:, j] = 1.0
            cols.append(torch.func.jvp(f, (q, ur), (tq, tu))[1])
    J = torch.stack(cols, dim=-1)
    return J[..., :q.shape[-1]], J[..., q.shape[-1]:]


def stages(f, qs, urs, dts, foh, n_keep: int, ar: Arith):
    """Discrete affine model of each stage t (B, T) of nodes qs (B, T+1,
    n), urs (B, T+1, m) over dts (B, T): x_{t+1} = A x_t + B0 u_t + Bf
    u_{t+1} + c, where u is the first `n_keep` input columns and the
    others (the path's parameters) fold into c; `foh` (T,) bool marks the
    ramping stages (Bf = 0 on the others).  Returns A (B, T, n, n), B0,
    Bf (B, T, n, n_keep), c (B, T, n)."""
    Bn, T = dts.shape
    n, m = qs.shape[-1], urs.shape[-1]
    q = qs[:, :T].reshape(Bn * T, n)
    u = urs[:, :T].reshape(Bn * T, m)
    Jq, Ju = jacobians(f, q, u)
    ct = f(q, u) - ar.mv(Jq, q) - ar.mv(Ju, u)
    dim = n + 2 * m + 1
    dt = dts.reshape(Bn * T)
    M = torch.zeros((Bn * T, dim, dim), dtype=q.dtype, device=q.device)
    M[:, :n, :n] = Jq * dt[:, None, None]
    M[:, :n, n:n + m] = Ju * dt[:, None, None]
    M[:, :n, -1] = ct * dt[:, None]
    ramp = (foh.to(q.dtype)[None, :].expand(Bn, T).reshape(-1) * dt)
    M[:, n:n + m, n + m:n + 2 * m] = ramp[:, None, None] * torch.eye(
        m, dtype=q.dtype, device=q.device)
    E = expm(M, ar).reshape(Bn, T, dim, dim)
    Bf = E[..., :n, n + m:n + 2 * m] / dts[..., None, None]
    B0 = E[..., :n, n:n + m] - Bf
    c = (E[..., :n, -1] + ar.mv(B0[..., n_keep:], urs[:, :T, n_keep:])
         + ar.mv(Bf[..., n_keep:], urs[:, 1:, n_keep:]))
    return E[..., :n, :n], B0[..., :n_keep], Bf[..., :n_keep], c
