"""OSQP-style ADMM QP solver in plain PyTorch, batched over a leading
instance dimension: containers, cold start, Ruiz equilibration, the
explicit KKT inverse and the segment loop with adaptive rho.  Counterpart
of `pigeon_tpu/solver/admm.py` with the natively batched "pallas"
pipeline (Ruiz kernel, banded factor, dense ADMM kernel) and the banded
factorization.

Canonical form: minimize 1/2 x'Px + q'x subject to l <= Ax <= u, with P a
dense (..., n, n) Hessian or a (..., n) diagonal.

    x~ : solve K x~ = sigma x - q + A'(rho z - y),  K = P + sigma I + A' rho A
    z~ = A x~
    x+ = alpha x~ + (1-alpha) x
    z+ = prox(alpha z~ + (1-alpha) z + y/rho)   (box, or shrink for soft rows)
    y+ = y + rho (alpha z~ + (1-alpha) z - z+)

The JAX package writes the solver for one instance and batches it with
`vmap`, under which its two nested `while_loop`s run until every instance
is done and a finished instance keeps its values.  Here the batch is a
leading dimension and that rule is written out: each loop carries a mask
of the instances still in it and every update is selected by the mask, so
an instance's result does not depend on the batch it is solved in.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import NamedTuple

import torch

from pigeon_tpu_torch.config import SolverOptions

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


class Pipeline(NamedTuple):
    """A kernel pipeline's pieces, as `run_segments` takes them after
    (qp, warm, opts): the Ruiz scalings (D, E, c), `factor(rho_vec)`,
    `run_iters(fac, x, z, y)`, the iterates' `layout` and the pipeline's
    equality rows and bf16 bulk."""
    D: torch.Tensor
    E: torch.Tensor
    c: torch.Tensor
    factor: object
    run_iters: object
    layout: "tuple | None" = None
    is_eq: "torch.Tensor | None" = None
    bulk: "tuple | None" = None


def cold_start(qp: QPData) -> QPWarmStart:
    z = torch.zeros_like(qp.l)
    return QPWarmStart(x=torch.zeros_like(qp.q), y=z, z=z,
                       rho_scale=torch.ones_like(qp.q[..., 0]))


# OSQP's adaptive rho: a refactor when the suggested multiplier moves by
# more than this factor
ADAPT_TOL = 5.0

# the process group the batch of `run_segments` is spread over (None: the
# batch is whole here); set by `global_batch`
_BATCH_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "batch_group", default=None)


@contextlib.contextmanager
def global_batch(group):
    """Inside, `run_segments` takes its loop decisions for the batch of
    every rank of `group` together: all ranks run the same segments and
    refactor together, as the whole batch would on one card (a refactor
    where no local instance drifted recomputes the same factor)."""
    token = _BATCH_GROUP.set(group)
    try:
        yield
    finally:
        _BATCH_GROUP.reset(token)


def _rho_start(qp: QPData, warm: QPWarmStart, opts: SolverOptions,
               is_eq=None):
    """Per-row base rho (equality rows get the stiff scaling, as OSQP) and
    the warm start's multiplier.  The equality rows are `is_eq` ((m,) or
    (B, m) bool) where given, else the rows with l == u at run time."""
    if is_eq is None:
        is_eq = (qp.u - qp.l) < 1e-10
    rho_base = torch.where(
        is_eq, torch.full_like(qp.l, opts.rho * opts.rho_eq_scale),
        torch.full_like(qp.l, opts.rho))
    rho_scale = (torch.ones_like(qp.q[:, 0]) if warm.rho_scale is None
                 else torch.clamp(warm.rho_scale, 1e-6, 1e6).to(qp.q.dtype))
    return rho_base, rho_scale


def rho_suggestion(rho_scale, r_prim, r_dual, m_prim, m_dual, amax_q):
    """OSQP's suggested multiplier from the residuals relative to their
    magnitudes: (the clamped new rho_scale, the factor it moved by)."""
    num = r_prim / torch.clamp(m_prim, min=1e-12)
    den = r_dual / torch.maximum(m_dual, torch.clamp(amax_q, min=1e-12))
    scale = torch.clamp(torch.sqrt(num / torch.clamp(den, min=1e-12)),
                        1e-3, 1e3)
    return torch.clamp(rho_scale * scale, 1e-6, 1e6), scale


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


# ---------------------------------------------------------------------------
# Core solve
# ---------------------------------------------------------------------------

def _factor_inv(Pb, Ab, rho_vec, sigma: float, opts: SolverOptions,
                banded_plan=None, unbatched: bool = False):
    """Explicit inverse of K = P + sigma I + A' rho A per instance:
    Pb (B, n) or (B, n, n), Ab (B, m, n), rho_vec (B, m).

    "chol": Cholesky and the triangular inverse.  "ns": Newton-Schulz
    X <- X (2I - K X) from X0 = K / ||K||_inf^2, `opts.ns_iters` steps,
    symmetrized.  "banded" and "banded_cr": the block-tridiagonal stage
    factor of `solver/banded.py` for a diagonal P and a `banded_plan`,
    "banded" its stage recursion (on the `banded_chol` kernel unless
    `unbatched`, the single-instance route, where the JAX package runs
    its XLA scan), "banded_cr" block cyclic reduction; without a plan, or
    with a dense P, both fall through to "chol", as in the JAX
    package."""
    method = opts.factor_method
    if method not in ("chol", "ns", "banded", "banded_cr"):
        raise ValueError(
            f"unknown factor_method={method!r} (one of 'chol', 'ns', "
            f"'banded', 'banded_cr')")
    if (method in ("banded", "banded_cr") and banded_plan is not None
            and Pb.dim() == Ab.dim() - 1):
        from pigeon_tpu_torch.solver.banded import factor_inv_banded
        slots, n_, bw, nb = banded_plan
        return factor_inv_banded(
            Pb, Ab, rho_vec, sigma, slots, n_, bw, nb, tp_axis=opts.tp_axis,
            method="cr" if method == "banded_cr" else "scan",
            kernel=not unbatched)
    n = Pb.shape[-1]
    eye = torch.eye(n, dtype=Ab.dtype, device=Ab.device)
    K = (Ab.transpose(-1, -2) * rho_vec[..., None, :]) @ Ab
    if Pb.dim() == Ab.dim():
        K = K + Pb + sigma * eye
    else:
        K = K + torch.diag_embed(Pb + sigma)
    if method == "ns":
        norm_inf = torch.abs(K).sum(dim=-1).amax(dim=-1)[..., None, None]
        X = K / (norm_inf * norm_inf)
        bulk = min(opts.ns_bf16_iters, opts.ns_iters)
        if bulk > 0:
            # the JAX package's bf16 bulk (admm.py:180-197; measured there
            # not to converge on the condensed KKT family, so off by
            # default): bf16 operands and a bf16 result in each step, the
            # products summed in float32
            bf = lambda t: t.to(torch.bfloat16)
            mm = lambda a, b: bf(a.float() @ b.float())
            Kb, Xb, eye2 = bf(K), bf(X), bf(2.0 * eye)
            for _ in range(bulk):
                Xb = mm(Xb, bf(eye2.float() - mm(Kb, Xb).float()))
            X = Xb.to(K.dtype)
        for _ in range(opts.ns_iters - bulk):
            X = X @ (2.0 * eye - K @ X)
        return 0.5 * (X + X.transpose(-1, -2))
    # a K that is not positive definite (a QP with non-finite data) gives
    # NaN, as the JAX package's Cholesky does, and no exception: the step's
    # NaN fallback handles it
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where(info[..., None, None] > 0, torch.nan, L)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    return Linv.transpose(-1, -2) @ Linv


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _mtv(M, v):
    return (v[..., None, :] @ M)[..., 0, :]


def _solve_masked(qp: QPData, warm: "QPWarmStart | None",
                  opts: SolverOptions, w_soft=None, banded_plan=None,
                  unbatched: bool = False, a_pattern=None) -> QPSolution:
    """The batched solve: every leaf of `qp` and `warm` has a leading
    batch dimension, `w_soft` is None or (B, m).  `unbatched` marks the
    single-instance route (`solve_qp`); there backend "pallas" (hard rows
    only) runs each segment on the dense ADMM kernel (`a_pattern` as in
    `solve_qp_batched`)."""
    dtype, dev = qp.q.dtype, qp.q.device
    B = qp.q.shape[0]
    if warm is None:
        warm = cold_start(qp)

    if opts.scaling_iters > 0:
        qps, D, E, c = ruiz(qp, opts.scaling_iters)
    else:
        qps, D, E = qp, torch.ones_like(qp.q), torch.ones_like(qp.l)
        c = torch.ones((B,), dtype=dtype, device=dev)
    Pb, qb, Ab, lb, ub = qps
    dense_P = qp.P_diag.dim() == 3
    sigma, alpha = float(opts.sigma), float(opts.alpha)
    c1 = c[:, None]
    # soft-row weights in the equilibrated space: W_bar = c W / E (the law
    # of y_bar)
    wb = None if w_soft is None else c1 * w_soft / E

    rho_base, rho_scale = _rho_start(qp, warm, opts)

    # the warm start in the equilibrated space
    x = warm.x / D
    z = E * warm.z
    y = c1 * warm.y / E
    n_seg = max(1, opts.max_iter // opts.check_every)
    amax = lambda v: torch.abs(v).amax(dim=-1)
    amax_q = amax(qp.q)

    def residuals(x, z, y):
        """Unscaled residuals, thresholds and magnitudes (OSQP)."""
        x_u = D * x
        z_u = z / E
        y_u = (E * y) / c1
        Ax = _mv(qp.A, x_u)
        Px = _mv(qp.P_diag, x_u) if dense_P else qp.P_diag * x_u
        Aty = _mtv(qp.A, y_u)
        r_prim = amax(Ax - z_u)
        r_dual = amax(Px + qp.q + Aty)
        m_prim = torch.maximum(amax(Ax), amax(z_u))
        m_dual = torch.maximum(amax(Px), amax(Aty))
        eps_prim = opts.eps_abs + opts.eps_rel * m_prim
        eps_dual = opts.eps_abs + opts.eps_rel * torch.maximum(m_dual,
                                                               amax_q)
        return r_prim, r_dual, eps_prim, eps_dual, m_prim, m_dual

    kernel_iterate = (
        _kernel_segment(Ab, qb, lb, ub, opts, a_pattern)
        if unbatched and opts.backend == "pallas" and wb is None else None)

    def iterate(Kinv, rho_vec, x, z, y):
        if kernel_iterate is not None:
            return kernel_iterate(Kinv, rho_vec, x, z, y)
        cap = None if wb is None else wb / rho_vec
        for _ in range(opts.check_every):
            rhs = sigma * x - qb + _mtv(Ab, rho_vec * z - y)
            x_t = _mv(Kinv, rhs)
            z_t = _mv(Ab, x_t)
            x_n = alpha * x_t + (1.0 - alpha) * x
            z_mix = alpha * z_t + (1.0 - alpha) * z
            v = z_mix + y / rho_vec
            if cap is None:
                z_n = torch.minimum(torch.maximum(v, lb), ub)
            else:
                # prox of W dist(., [l, u]) / rho: shrink toward the box by
                # at most W / rho a side (an infinite cap is the projection)
                z_n = (v - torch.minimum(torch.clamp(v - ub, min=0.0), cap)
                       - torch.clamp(torch.maximum(v - lb, -cap), max=0.0))
            y = y + rho_vec * (z_mix - z_n)
            x, z = x_n, z_n
        return x, z, y

    # Two levels, as OSQP: the outer level factorizes; the inner level runs
    # `check_every`-iteration segments against the fixed factor and leaves
    # when the instance has converged, spent its segments, or its adaptive
    # rho has drifted by more than ADAPT_TOL (then the outer level
    # refactors).  `outer` and `inner` are the masks of the instances that
    # are in each loop.
    seg_i = torch.zeros((B,), dtype=torch.int32, device=dev)
    r_prim = torch.full((B,), math.inf, dtype=dtype, device=dev)
    r_dual = r_prim.clone()
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)
    outer = ~converged
    while bool(outer.any()):
        rho_vec = torch.clamp(rho_base * rho_scale[:, None], RHO_MIN,
                              RHO_MAX)
        Kinv = _factor_inv(Pb, Ab, rho_vec, sigma, opts, banded_plan,
                           unbatched)
        pending = rho_scale
        drift = torch.zeros_like(converged)
        inner = outer            # at least one segment per factorization
        while bool(inner.any()):
            x_n, z_n, y_n = iterate(Kinv, rho_vec, x, z, y)
            rp, rd, eps_p, eps_d, m_prim, m_dual = residuals(x_n, z_n, y_n)
            conv = (rp <= eps_p) & (rd <= eps_d)
            if opts.adaptive_rho:
                pend, scale = rho_suggestion(rho_scale, rp, rd, m_prim,
                                             m_dual, amax_q)
                dr = ((scale > ADAPT_TOL) | (scale < 1.0 / ADAPT_TOL)) & ~conv
            else:
                pend, dr = pending, torch.zeros_like(conv)
            sel = inner[:, None]
            x = torch.where(sel, x_n, x)
            z = torch.where(sel, z_n, z)
            y = torch.where(sel, y_n, y)
            seg_i = torch.where(inner, seg_i + 1, seg_i)
            r_prim = torch.where(inner, rp, r_prim)
            r_dual = torch.where(inner, rd, r_dual)
            converged = torch.where(inner, conv, converged)
            pending = torch.where(inner, pend, pending)
            drift = torch.where(inner, dr, drift)
            inner = outer & (seg_i < n_seg) & ~converged & ~drift
        rho_scale = torch.where(outer & drift, pending, rho_scale)
        outer = (seg_i < n_seg) & ~converged

    return QPSolution(
        x=D * x, y=(E * y) / c1, z=z / E,
        iterations=seg_i * opts.check_every, prim_res=r_prim,
        dual_res=r_dual, converged=converged, rho_scale=rho_scale)


def _kernel_segment(Ab, qb, lb, ub, opts: SolverOptions, a_pattern=None):
    """One segment of `opts.check_every` iterations on the dense ADMM
    kernel at tile 1 without its statistics or early exit (the JAX
    package's unbatched "pallas" route, admm.py:286-294, which runs mode
    "highest" whatever `opts.pallas_precision` says): the kernel computes
    in float32, the iterates return in the QP's dtype, and the caller
    computes the residuals.  On the card A is packed into
    `a_pattern`'s ELL form once (the pattern of A itself when None)."""
    from pigeon_tpu_torch.solver.pallas_admm import admm_iterations

    dtype = qb.dtype
    f32 = lambda t: t.to(torch.float32).contiguous()
    ops = [f32(t) for t in (Ab, qb, lb, ub)]
    ell = _ell_form(ops[0], a_pattern)

    def run(Kinv, rho_vec, x, z, y):
        out = admm_iterations(f32(Kinv), *ops, f32(rho_vec), f32(x), f32(z),
                              f32(y), opts.check_every, float(opts.sigma),
                              float(opts.alpha), tile=1, **ell)
        return tuple(t.to(dtype) for t in out[:3])

    return run


def _ell_form(A, a_pattern=None, mode: str = "highest", m_eq: int = 0,
              dense_P: bool = False, shared: dict = None) -> dict:
    """The dense ADMM kernel's A on the card: `a_pattern` (the pattern of
    the batch A when None, one host read) in the build of `mode` and
    `dense_P` (`EllPattern.for_mode`) and A packed into it once, as
    keyword arguments of `pallas_admm.admm_iterations` (`shared`, another
    mode's form of the same A, where its pattern is that build already);
    nothing for a CPU tensor, whose plain version reads A dense."""
    from pigeon_tpu_torch.solver.pallas_admm import pack, pattern_from

    if A.device.type == "cpu":
        return {}
    if shared:
        pattern = shared["pattern"].for_mode(mode, m_eq, dense_P)
        if pattern is shared["pattern"]:
            return shared
    else:
        pattern = (a_pattern if a_pattern is not None
                   else pattern_from(A)).for_mode(mode, m_eq, dense_P)
    return dict(pattern=pattern, A_packed=pack(A, pattern))


def solve_qp(qp: QPData, warm: "QPWarmStart | None" = None,
             opts: SolverOptions = SolverOptions(), banded_plan=None,
             eq_rows=None, w_soft=None, a_pattern=None) -> QPSolution:
    """Solve one QP: P (n,) or (n, n), q (n,), A (m, n), l, u (m,).

    banded_plan: the static stage plan (`solver/banded.py`) that
    factor_method "banded" needs; on this route its stage recursion is
    the plain PyTorch scan, as the JAX package's unbatched factor is its
    XLA scan.  eq_rows: accepted for symmetry with `solve_qp_batched`; as
    in the JAX package this route runs the kernel in mode "highest"
    whatever `opts.pallas_precision` says.
    w_soft: optional (m,) exact-penalty weights (inf = hard row); a
    finite-weight row's z-update is the shrinkage prox of
    W dist(., [l, u]) in place of the box projection.  As in the JAX
    package, a soft solve runs this iteration body whatever `opts.backend`
    says.  A hard solve on backend "pallas" runs each segment on the
    dense ADMM kernel at tile 1 (`_kernel_segment`; `a_pattern` A's
    static nonzero pattern for it) and the rest of the solver here."""
    lift = lambda t: None if t is None else t[None]
    if warm is not None:
        warm = QPWarmStart(*[lift(t) for t in warm])
    sol = _solve_masked(QPData(*[t[None] for t in qp]), warm, opts,
                        lift(w_soft), banded_plan, unbatched=True,
                        a_pattern=a_pattern)
    return QPSolution(*[t[0] for t in sol])


def solve_qp_batched(qp: QPData, warm: QPWarmStart,
                     opts: SolverOptions = SolverOptions(),
                     banded_plan=None, eq_rows=None,
                     w_soft=None, a_pattern=None) -> QPSolution:
    """Solve a batch of QPs (leading batch dimension on every leaf).
    backend "xla": `solve_qp` per instance, as a masked batch; "lanes":
    the lane solver on its CUDA kernels (`solver/lane_admm.py`); "pallas":
    the natively batched pipeline (`pallas_pipeline`) for hard
    QPs, with a diagonal or a dense P.  w_soft: (m,) or (B, m), for "xla" and
    "lanes".  eq_rows: the statically known equality rows (indices into
    the m rows), which "pallas"'s mixed precision modes run in float32
    and give the stiff rho.  a_pattern: A's static nonzero pattern
    (`pallas_admm.EllPattern`) for "pallas"'s dense ADMM kernel; without
    it the pipeline derives the batch's (one host read per solve)."""
    if opts.backend == "lanes":
        from pigeon_tpu_torch.solver.lane_admm import solve_lanes_batched
        return solve_lanes_batched(qp, warm, opts, w_soft)
    if opts.backend == "pallas":
        if w_soft is not None:
            raise NotImplementedError(
                "soft rows are supported by the 'xla' and 'lanes' backends; "
                "the dense ADMM kernel has no shrink prox")
        return run_segments(qp, warm, opts, *pallas_pipeline(
            qp, opts, banded_plan, a_pattern, eq_rows))
    if opts.backend != "xla":
        raise ValueError(f"unknown solver backend {opts.backend!r} (one of "
                         f"'xla', 'lanes', 'pallas')")
    if w_soft is not None and w_soft.dim() == 1:
        w_soft = w_soft.expand(qp.l.shape)
    return _solve_masked(qp, warm, opts, w_soft, banded_plan)


def run_segments(qp: QPData, warm: QPWarmStart, opts: SolverOptions, D, E,
                 c, factor, run_iters, layout=None, is_eq=None,
                 bulk=None) -> QPSolution:
    """The segment loop of the kernel pipelines ("lanes" and "pallas"),
    on the scalings (D, E, c) of the Ruiz step: up to `max_iter //
    check_every` segments of `run_iters(fac, x, z, y) -> (x, z, y, stats)`
    on the whole batch, stats (B, 8) the unscaled residual statistics with
    the executed iterations in column 6, and `fac = factor(rho_vec)` the
    factor of the per-row rho.

    Unlike the masked "xla" loop, a segment runs on the whole batch until
    every instance has converged, so a converged instance keeps iterating
    in later segments and its executed iterations keep adding up, as the
    JAX package's loops do.  When an instance's adaptive rho drifts and
    another segment follows, the whole batch is refactored (the others
    keep their rho, so their factor does not change).  Between segments
    two flags are read on the host: one sync per segment but the last
    (inside `global_batch`, reduced over its group first).
    `layout` = (to, back) maps the (B, k) iterates to run_iters' layout
    and back.  `is_eq`: the equality rows for the stiff rho (`_rho_start`).
    `bulk` = (n, run): `run(fac, x, z, y)` runs n iterations before the
    segments (the "pallas" pipeline's bf16 bulk phase, JAX admm.py:
    565-580): its statistics set no convergence, at least one segment
    follows, and the executed count starts at n."""
    to_k, back = layout or (lambda v: v, lambda v: v)
    dtype, dev = qp.q.dtype, qp.q.device
    B = qp.q.shape[0]
    rho_base, rho_scale = _rho_start(qp, warm, opts, is_eq)
    rho_of = lambda s: torch.clamp(rho_base * s[:, None], RHO_MIN, RHO_MAX)
    x, z, y = (to_k(v) for v in (warm.x / D, E * warm.z,
                                 c[:, None] * warm.y / E))
    amax_qu = torch.abs(qp.q).amax(dim=-1)
    fac = factor(rho_of(rho_scale))
    n_seg = max(1, opts.max_iter // opts.check_every)
    r_prim = r_dual = torch.full((B,), math.inf, dtype=dtype, device=dev)
    converged = torch.zeros((B,), dtype=torch.bool, device=dev)
    iters_acc = torch.zeros((B,), dtype=dtype, device=dev)
    if bulk is not None:
        x, z, y, _ = bulk[1](fac, x, z, y)
        iters_acc = iters_acc + float(bulk[0])
    for seg in range(n_seg):
        x, z, y, stats = run_iters(fac, x, z, y)
        stats = stats.to(dtype)
        iters_acc = iters_acc + stats[:, 6]
        r_prim, r_dual, m_Ax, m_z, m_Px, m_Aty = stats[:, :6].unbind(-1)
        m_prim = torch.maximum(m_Ax, m_z)
        m_dual = torch.maximum(m_Px, m_Aty)
        eps_p = opts.eps_abs + opts.eps_rel * m_prim
        eps_d = opts.eps_abs + opts.eps_rel * torch.maximum(m_dual, amax_qu)
        converged = (r_prim <= eps_p) & (r_dual <= eps_d)
        drift = torch.zeros_like(converged)
        if opts.adaptive_rho:
            pending, scale = rho_suggestion(rho_scale, r_prim, r_dual,
                                            m_prim, m_dual, amax_qu)
            drift = (((scale > ADAPT_TOL) | (scale < 1.0 / ADAPT_TOL))
                     & ~converged)
            rho_scale = torch.where(drift, pending, rho_scale)
        if seg + 1 == n_seg:
            break
        flags = torch.stack([~converged.all(), drift.any()])
        group = _BATCH_GROUP.get()
        if group is not None:
            import torch.distributed as dist

            flags = flags.to(torch.int32)
            dist.all_reduce(flags, op=dist.ReduceOp.MAX, group=group)
        some_open, any_drift = (bool(f) for f in flags.tolist())
        if not some_open:
            break
        if any_drift:
            fac = factor(rho_of(rho_scale))
    x, z, y = (back(v).to(dtype) for v in (x, z, y))
    return QPSolution(
        x=D * x, y=(E * y) / c[:, None], z=z / E,
        iterations=iters_acc.to(torch.int32), prim_res=r_prim,
        dual_res=r_dual, converged=converged, rho_scale=rho_scale)


def kernel_pipeline(qp: QPData, opts: SolverOptions, banded_plan=None,
                    a_pattern=None, eq_rows=None, w_soft=None) -> Pipeline:
    """The pipeline of `opts.backend` ("lanes" or "pallas") for a batch,
    as `solve_qp_batched` runs it (`run_segments(qp, warm, opts,
    *pipeline)`); the profiler times its pieces."""
    if opts.backend == "lanes":
        from pigeon_tpu_torch.solver.lane_admm import lanes_pipeline
        return lanes_pipeline(qp, opts, w_soft)
    if opts.backend == "pallas" and w_soft is None:
        return pallas_pipeline(qp, opts, banded_plan, a_pattern, eq_rows)
    raise ValueError(f"backend {opts.backend!r} (soft rows: "
                     f"{w_soft is not None}) has no kernel pipeline")


def pallas_pipeline(qp: QPData, opts: SolverOptions, banded_plan=None,
                    a_pattern=None, eq_rows=None) -> Pipeline:
    """The natively batched pipeline of the JAX package's "pallas"
    backend, as the pieces `run_segments` runs: Ruiz equilibration
    (`pallas_ruiz.ruiz_batched`, run here), the K^-1 of `_factor_inv` for
    the whole batch, and segments of `check_every` iterations through
    `pallas_admm.admm_iterations`, each with the in-kernel early exit per
    tile of `opts.pallas_tile` instances, in the mode
    `opts.pallas_precision`.  On the card the scaled A is packed once per
    solve into `a_pattern` (the pattern of the batch when None) in the
    kernel build of that mode and P (`pallas_admm.
    plan_build`: the sparse QP's narrow build in "highest", its large one
    in the split modes), and the bf16 bulk's in its own.  The kernels
    compute in float32, the rest in the QP's dtype.

    A dense P (the condensed QP, JAX admm.py:446-463): the Ruiz kernel
    scales from the row maxima of |P| in place of the diagonal, the
    scaled P = c D P D is formed here, and the ADMM kernel's statistics
    take P x from the dense unscaled P.

    The mixed modes with `eq_rows` (JAX admm.py:465-515): the stiff rho
    goes to the rows of `eq_rows`, not to those with l == u at run time,
    and the kernel sees the rows permuted, `eq_rows` first (no permutation
    when they lead already, as in every layout); K = A' rho A does not
    depend on the rows' order, so the factor takes them as they are.
    Without `eq_rows` a mixed mode raises ValueError, as in the JAX
    package.  `opts.bf16_bulk_iters` > 0 runs that many iterations in
    mode "bf16" before the segments (`run_segments`' bulk)."""
    from pigeon_tpu_torch.solver.pallas_admm import (MIXED_MODES,
                                                     admm_iterations)
    from pigeon_tpu_torch.solver.pallas_ruiz import ruiz_batched

    dtype = qp.q.dtype
    m = qp.l.shape[-1]
    dense_P = qp.P_diag.dim() == 3
    f32 = lambda t: t.to(torch.float32).contiguous()
    if opts.scaling_iters > 0:
        # dense P: scale from the row maxima of |P| (its diagonal alone
        # underestimates the condensed G'WG block's scale)
        P_scale = qp.P_diag.abs().amax(dim=-1) if dense_P else qp.P_diag
        out = ruiz_batched(f32(P_scale), *[f32(t) for t in qp[1:]],
                           iters=opts.scaling_iters)
        Pb, qb, Ab, lb, ub, D, E, c = [t.to(dtype) for t in out]
        if dense_P:
            Pb = (c[:, None, None] * qp.P_diag * D[:, :, None]
                  * D[:, None, :])
    else:
        Pb, qb, Ab, lb, ub = qp
        D, E = torch.ones_like(qp.q), torch.ones_like(qp.l)
        c = torch.ones_like(qp.q[:, 0])
    sigma = float(opts.sigma)

    def factor(rho_vec):
        return (f32(_factor_inv(Pb, Ab, rho_vec, sigma, opts, banded_plan)),
                f32(rho_vec))

    is_eq, m_eq, perm = None, 0, None
    if opts.pallas_precision in MIXED_MODES and eq_rows is not None:
        eq = torch.as_tensor(eq_rows, dtype=torch.long).flatten().cpu()
        m_eq = int(eq.numel())
        is_eq = torch.zeros(m, dtype=torch.bool)
        is_eq[eq] = True
        if not torch.equal(eq, torch.arange(m_eq)):
            perm = torch.cat([eq, torch.arange(m)[~is_eq]]).to(qp.q.device)
        is_eq = is_eq.to(qp.q.device)
    rows = (lambda t: t) if perm is None else (lambda t: t[:, perm])
    kernel_ops = [f32(rows(Ab)), f32(qb), f32(rows(lb)), f32(rows(ub))]
    scalings = tuple(f32(t) for t in (D, rows(E), c, qp.P_diag, qp.q))
    # a permuted A takes the pattern of its own nonzeros, in the build of
    # the segments' mode; the bf16 bulk's build is its own mode's, and it
    # shares the segments' packed A where that is its build
    ell = _ell_form(kernel_ops[0], a_pattern if perm is None else None,
                    opts.pallas_precision, m_eq, dense_P)

    def run(n_iters, ell=ell, **mode):
        def go(fac, x, z, y):
            x, z, y, st = admm_iterations(
                fac[0], *kernel_ops, rows(fac[1]), x, rows(z), rows(y),
                n_iters, sigma, float(opts.alpha), tile=opts.pallas_tile,
                scalings=scalings, check=int(opts.pallas_check_inner),
                dense_P=dense_P, eps_abs=float(opts.eps_abs),
                eps_rel=float(opts.eps_rel), m_eq=m_eq, **ell, **mode)
            if perm is not None:
                z = torch.empty_like(z).index_copy_(1, perm, z)
                y = torch.empty_like(y).index_copy_(1, perm, y)
            return x, z, y, st
        return go

    bulk = (None if opts.bf16_bulk_iters <= 0 else
            (opts.bf16_bulk_iters, run(
                opts.bf16_bulk_iters, bf16=True, ell=_ell_form(
                    kernel_ops[0], mode="bf16", dense_P=dense_P,
                    shared=ell))))
    return Pipeline(D, E, c, factor,
                    run(opts.check_every, precision=opts.pallas_precision),
                    layout=(f32, lambda v: v), is_eq=is_eq, bulk=bulk)
