"""Integration and horizon linearization.  Counterpart of
`pigeon_tpu/discretize.py`: RK4 `propagate`, the reference's linearization
by differentiating RK4 steps (`linearize_zoh`, `linearize_foh`: plain
ops, no kernel), the fixed scaling-and-squaring `expm_fixed` and its CUDA
kernel `expm_dense` (`csrc/expm_dense.cu`), and the fused ZOH/FOH horizon
linearization.  Its Van Loan exponential takes
one of two routes, as in the JAX package: the structured form
(`csrc/vanloan.cu`) for a fleet, the dense stage matrix through
`expm_dense` for the unbatched controller.  The sparse decoupled QP
linearizes each stage on its own (`linearize_affine_zoh`, `_foh`), on
`expm_dense` for a fleet and for one vehicle alike, as the JAX package's
`vmap` of them does.

Dynamics callables have signature f(q, ur) -> qdot with the trailing `ur`
the stacked [u2; p4] input and broadcast over leading dimensions; `n_keep`
columns of the input Jacobian stay decision variables, the rest (the
trajectory parameters) fold into the affine offset.
"""

from __future__ import annotations

import math

import torch

from pigeon_tpu_torch import _kernels


# ---------------------------------------------------------------------------
# RK4 integration
# ---------------------------------------------------------------------------

def rk4_step(f, q, ur, dt):
    """One classical RK4 step with constant input."""
    k1 = f(q, ur)
    k2 = f(q + 0.5 * dt * k1, ur)
    k3 = f(q + 0.5 * dt * k2, ur)
    k4 = f(q + dt * k3, ur)
    return q + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def rk4_step_ramp(f, q, ur0, urf, dt):
    """One RK4 step with the input ramping linearly from ur0 to urf over
    dt (the reference's RampControl): stage inputs at tau = 0, dt/2, dt/2,
    dt."""
    urm = 0.5 * (ur0 + urf)
    k1 = f(q, ur0)
    k2 = f(q + 0.5 * dt * k1, urm)
    k3 = f(q + 0.5 * dt * k2, urm)
    k4 = f(q + dt * k3, urf)
    return q + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def propagate(f, q, ur, dt, substeps: int = 1):
    """Integrate f over dt with constant input (the plant step)."""
    h = dt / substeps
    for _ in range(substeps):
        q = rk4_step(f, q, ur, h)
    return q


# ---------------------------------------------------------------------------
# Discrete linearization by differentiating the integrator (the reference
# coupled controller's path, src/coupled_lat_long.jl:253,262)
# ---------------------------------------------------------------------------

def _ramp_propagate(f, q, ur0, urf, h, substeps: int):
    """`substeps` ramp RK4 steps of h each; substep i ramps from
    ur0 + (urf - ur0) i/k to ur0 + (urf - ur0) (i+1)/k."""
    for i in range(substeps):
        u_a = ur0 + (urf - ur0) * (i / substeps)
        u_b = ur0 + (urf - ur0) * ((i + 1) / substeps)
        q = rk4_step_ramp(f, q, u_a, u_b, h)
    return q


def linearize_zoh(f, q, ur, dt, n_keep: int, substeps: int = 1):
    """Discrete ZOH affine model of each row by differentiating
    `substeps` RK4 steps over dt: q (K, n), ur (K, m), dt (K,) -> A (K, n,
    n), B (K, n, n_keep), c (K, n), the input's other columns folded into
    c (`pigeon_tpu.discretize.linearize_zoh`, batched).

    Explicit RK4 is stable only for |lambda| dt / substeps < 2.78; the
    lateral tire modes reach |lambda| ~ 250/Ux 1/s, so one step over
    dt_long = 0.2 gives an amplifying model (the reference's own; see
    `parity.stable_substeps`)."""
    # dt rides along as an argument, repeated with the rows (its column
    # of the Jacobian is dropped)
    def g(q_, ur_, dt_):
        return propagate(f, q_, ur_, dt_, substeps)

    A, B_full, _ = batched_jacobians(g, q, ur, dt[:, None])
    B = B_full[..., :n_keep]
    c = (g(q, ur, dt[:, None]) - torch.einsum("kij,kj->ki", A, q)
         - torch.einsum("kij,kj->ki", B, ur[:, :n_keep]))
    return A, B, c


def linearize_foh(f, q, ur0, urf, dt, n_keep: int, substeps: int = 1):
    """Discrete FOH affine model of each row by differentiating
    `substeps` ramp RK4 steps over dt with respect to q, ur0 and urf, the
    inputs at the step's two ends: A (K, n, n), B0, Bf (K, n, n_keep),
    c (K, n) (`pigeon_tpu.discretize.linearize_foh`, batched).  Same
    stability caveat as `linearize_zoh`."""
    h = (dt / substeps)[:, None]

    def g(q_, ur0_, urf_, h_):
        return _ramp_propagate(f, q_, ur0_, urf_, h_, substeps)

    A, B0_full, Bf_full, _ = batched_jacobians(g, q, ur0, urf, h)
    B0, Bf = B0_full[..., :n_keep], Bf_full[..., :n_keep]
    c = (g(q, ur0, urf, h) - torch.einsum("kij,kj->ki", A, q)
         - torch.einsum("kij,kj->ki", B0, ur0[:, :n_keep])
         - torch.einsum("kij,kj->ki", Bf, urf[:, :n_keep]))
    return A, B0, Bf, c


def expm_fixed(M, squarings: int = 8, order: int = 8):
    """Matrix exponential of (..., d, d) by fixed scaling-and-squaring and
    a Horner Taylor sum (the dense oracle of the structured kernel)."""
    n = M.shape[-1]
    S = M / (2.0 ** squarings)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    E = eye + S / order
    for k in range(order - 1, 0, -1):
        E = eye + (S @ E) / k
    for _ in range(squarings):
        E = E @ E
    return E


# The dense kernel: a block a matrix, a thread an entry, so d <= 32; exact
# builds for the stage matrices of the two formulations (n + 2 m + 1 = 19
# coupled, 17 decoupled), the run-time build 0 for every other d (the
# sparse decoupled QP's 11 x 11 ZOH stages among them).
EXPM_D_MAX = 32
EXPM_BUILDS = (19, 17)


def expm_build(d: int) -> int:
    """The build of `csrc/expm_dense.cu` for d x d matrices: d where an
    exact build exists (`EXPM_BUILDS`), else 0, the run-time build.
    ValueError for d outside 1..EXPM_D_MAX."""
    if not 1 <= d <= EXPM_D_MAX:
        raise ValueError(f"the CUDA kernel takes 1 <= d <= {EXPM_D_MAX}, "
                         f"got {d}")
    return d if d in EXPM_BUILDS else 0


def expm_dense(M, squarings: int = 8, order: int = 8):
    """`expm_fixed` of a (..., d, d) stack, d <= 32.  CUDA tensors
    (float32, contiguous) launch `csrc/expm_dense.cu`, one thread block
    per matrix and one thread per entry, in the build `expm_build` picks;
    CPU tensors run `expm_fixed`.

    Replaces the TPU kernels `pigeon_tpu/discretize.py:_expm_lane_kernel`
    and `_expm_chain_kernel` (the same chain, on lanes and on packed
    128 x 128 tiles).  Per matrix it moves 8 d^2 bytes and does
    2 d^3 (order - 1 + squarings) FLOP: bound by operations for a large
    stack, by the chain of products for the 15 or 30 stage matrices of
    one vehicle."""
    if M.dim() < 2 or M.shape[-1] != M.shape[-2]:
        raise ValueError(f"M must be (..., d, d), got {tuple(M.shape)}")
    if order < 1 or squarings < 0:
        raise ValueError(f"expm_dense needs order >= 1 and squarings >= 0, "
                         f"got {order}, {squarings}")
    _kernels.check_same(M=(M, tuple(M.shape)))
    if M.device.type == "cpu":
        return expm_fixed(M, squarings, order)
    _kernels.check_cuda_f32(M=M)
    d = M.shape[-1]
    out = torch.empty_like(M)
    _kernels.KERNELS["expm_dense"].launch(
        M, out, M.numel() // (d * d), d, squarings, order, expm_build(d))
    return out


# ---------------------------------------------------------------------------
# Van Loan exponential of the FOH/ZOH stage augmentation
# ---------------------------------------------------------------------------
#
# The fused-horizon stage matrix is block upper triangular,
#
#     M dt = [[ P, Cu, 0, cc ],        P  = Jq dt   (n x n)
#             [ 0,  0, rI, 0  ],        Cu = Ju dt   (n x m)
#             [ 0,  0,  0, 0  ],        cc = c  dt   (n x 1)
#             [ 0,  0,  0, 0  ]]        r  = foh dt  (scalar)
#
# with a nilpotent lower-right block, so exp(M dt) needs only the n x n
# chain and its action on the augmentation columns:
#
#     e11 = sum_j P^j / j!,  U = sum P^i/(i+1)!,  W = sum P^i/(i+2)!
#     X = U Cu,  Y = r W Cu,  z = U cc
#     squaring: X' = e11 X + X;  Y' = e11 Y + Y + r_cur X;  z' = e11 z + z;
#               e11' = e11 e11;  r_cur *= 2
#
# Outputs (A = e11, Phi_qu = X, Phi_qv = Y, zcol = z).

def _check_order(order: int):
    # U starts at I and W at I/2: that truncation equals the dense
    # order-`order` Taylor polynomial only for order >= 2
    if order < 2:
        raise ValueError(f"vanloan needs order >= 2, got {order}")


# (n, m) of the models the kernel is built for: tracking and lateral
VANLOAN_SHAPES = ((6, 6), (4, 6))
# consecutive (instance, stage) items of a chunk of the kernel, by n: a
# block takes n threads for each, a whole number of warps
VANLOAN_STAGES = {6: 32, 4: 64}
# a block's shared memory is static, so within 48 KB
VANLOAN_SMEM_MAX = 48 * 1024


def vanloan_plan(n: int, m: int) -> tuple:
    """(stages a chunk, threads a block, shared bytes a block) of the
    kernel's (n, m) build -- (32, 192, 34,816) at (6, 6), (64, 256,
    40,448) at (4, 6) -- or ValueError for an (n, m) it is not built
    for.  A block's shared memory holds two chunks' input slabs (P0, Cu0,
    cc0, rr), the next loading while it works on the current one, and a
    chunk's output slabs (A, X, Y, z)."""
    if (n, m) not in VANLOAN_SHAPES:
        raise ValueError(f"the CUDA kernel is built for (n, m) in "
                         f"{VANLOAN_SHAPES}, got {(n, m)}")
    stages = VANLOAN_STAGES[n]
    ins = n * n + n * m + n + 1
    outs = n * n + 2 * n * m + n
    need = 4 * stages * (2 * ins + outs)
    if need > VANLOAN_SMEM_MAX:
        raise ValueError(f"a vanloan block at (n, m) = ({n}, {m}) needs "
                         f"{need} B of shared memory, over {VANLOAN_SMEM_MAX}")
    return stages, stages * n, need


def vanloan_plain(P0, Cu0, cc0, rr, squarings: int, order: int):
    """Plain PyTorch version of the structured Van Loan exponential:
    P0 (..., n, n), Cu0 (..., n, m), cc0 (..., n, 1), rr (...) ->
    (A, Phi_qu, Phi_qv, zcol)."""
    _check_order(order)
    s = 1.0 / 2.0 ** squarings
    P = P0 * s
    Cu = Cu0 * s
    cc = cc0 * s
    r = rr[..., None, None] * s
    eye = torch.eye(P.shape[-1], dtype=P.dtype, device=P.device)
    Pj = eye.expand_as(P)
    e11, U, W = Pj, Pj, Pj * 0.5
    for j in range(1, order + 1):
        Pj = Pj @ P
        e11 = e11 + Pj * (1.0 / math.factorial(j))
        if j <= order - 1:
            U = U + Pj * (1.0 / math.factorial(j + 1))
        if j <= order - 2:
            W = W + Pj * (1.0 / math.factorial(j + 2))
    X = U @ Cu
    Y = r * (W @ Cu)
    z = U @ cc
    rcur = r
    for _ in range(squarings):
        X, Y, z = (e11 @ X + X, e11 @ Y + Y + rcur * X, e11 @ z + z)
        e11 = e11 @ e11
        rcur = rcur * 2.0
    return e11, X, Y, z


def vanloan(P0, Cu0, cc0, rr, squarings: int, order: int):
    """Structured Van Loan exponential per (instance, stage).

    P0 (B, T, n, n), Cu0 (B, T, n, m), cc0 (B, T, n, 1), rr (B, T).
    CUDA tensors (float32, contiguous) launch `csrc/vanloan.cu`, built
    for (n, m) = (6, 6) and (4, 6): resident blocks walk over chunks of
    `vanloan_plan`'s consecutive (instance, stage) items, staged through
    shared memory, one thread per row of a stage; CPU tensors run
    `vanloan_plain`.

    Replaces the TPU kernel `pigeon_tpu/discretize.py:_vanloan_lane_kernel`.
    At n = 6 it moves 772 B per (instance, stage) (95 MB per step at
    B=8192, T=15) and does ~10.9 kFLOP there at order 6 and 4 squarings
    (1.34 GFLOP): bound by the bytes (0.028 ms on an H100), just above the
    operations (0.020 ms)."""
    _check_order(order)
    if P0.dim() != 4:
        raise ValueError(f"P0 must be (B, T, n, n), got {tuple(P0.shape)}")
    B, T, n = P0.shape[:3]
    m = Cu0.shape[-1]
    _kernels.check_same(P0=(P0, (B, T, n, n)), Cu0=(Cu0, (B, T, n, m)),
                        cc0=(cc0, (B, T, n, 1)), rr=(rr, (B, T)))
    if P0.device.type == "cpu":
        return vanloan_plain(P0, Cu0, cc0, rr, squarings, order)
    _kernels.check_cuda_f32(P0=P0, Cu0=Cu0, cc0=cc0, rr=rr)
    vanloan_plan(n, m)
    A = torch.empty_like(P0)
    Xo = torch.empty_like(Cu0)
    Yo = torch.empty_like(Cu0)
    zo = torch.empty_like(cc0)
    _kernels.KERNELS["vanloan"].launch(
        P0, Cu0, cc0, rr, A, Xo, Yo, zo, B * T, n, m, squarings, order)
    return A, Xo, Yo, zo


def vanloan_dense(P0, Cu0, cc0, rr, squarings: int, order: int):
    """The same four blocks from the dense (n + 2m + 1)^2 stage matrix
    through `expm_dense`: the route the unbatched controller takes, as
    the JAX package's does.  Shapes as `vanloan`, any leading dimensions.
    A ZOH stage (rr = 0) leaves Phi_qv at rounding level, not exactly 0
    as the structured form does."""
    n, m = Cu0.shape[-2:]
    lead = tuple(P0.shape[:-2])
    _kernels.check_same(P0=(P0, lead + (n, n)), Cu0=(Cu0, lead + (n, m)),
                        cc0=(cc0, lead + (n, 1)), rr=(rr, lead))
    dim = n + 2 * m + 1
    M = torch.zeros(lead + (dim, dim), dtype=P0.dtype, device=P0.device)
    M[..., :n, :n] = P0
    M[..., :n, n:n + m] = Cu0
    M[..., :n, -1] = cc0[..., 0]
    M[..., n:n + m, n + m:n + 2 * m] = (
        rr[..., None, None] * torch.eye(m, dtype=P0.dtype, device=P0.device))
    E = expm_dense(M, squarings, order)
    return (E[..., :n, :n], E[..., :n, n:n + m], E[..., :n, n + m:n + 2 * m],
            E[..., :n, -1:])


def batched_jacobians(f, *args):
    """Per-row Jacobians of a row-wise function f(a0 (K, n0), a1 (K, n1),
    ...) -> (K, d), one for each argument: (K, d, n0), (K, d, n1), ...

    One forward-mode pass (`torch.func.jvp`) over the rows repeated once
    for each input column, copy j carrying the j-th basis vector as its
    tangent: the instance batch stays a plain leading dimension, so every
    intermediate stays (K,)-shaped and in the input dtype (the
    per-instance `vmap(jacfwd(f))` indexes 0-d tensors inside the
    dynamics, and under vmap a 0-d float32 tensor times a Python float
    promotes to float64), and no op goes through vmap's batching rules.
    Since f sees the rows repeated, every row-wise tensor f reads must be
    one of `args`: a (K, ...) tensor f closes over would not line up with
    the repeated rows."""
    K = args[0].shape[0]
    sizes = [a.shape[-1] for a in args]
    total = sum(sizes)
    tangents, start = [], 0
    for a, size in zip(args, sizes):
        t = torch.zeros((total, K, size), dtype=a.dtype, device=a.device)
        j = torch.arange(size, device=a.device)
        t[start + j, :, j] = 1.0
        tangents.append(t.reshape(total * K, size))
        start += size
    primals = tuple(a.repeat(total, 1) for a in args)
    out = torch.func.jvp(f, primals, tuple(tangents))[1]
    out = out.reshape(total, K, -1).permute(1, 2, 0)
    return tuple(torch.split(out, sizes, dim=-1))


def continuous_affine(f, q, ur):
    """Continuous linearization qdot ~= Jq q + Ju ur + ct at each row of
    q (K, n), ur (K, m): Jq (K, n, n), Ju (K, n, m), ct (K, n)
    (`pigeon_tpu.discretize._continuous_affine`, batched)."""
    Jq, Ju = batched_jacobians(f, q, ur)
    ct = (f(q, ur) - torch.einsum("kij,kj->ki", Jq, q)
          - torch.einsum("kij,kj->ki", Ju, ur))
    return Jq, Ju, ct


def linearize_affine_zoh(f, q, ur, dt, n_keep: int):
    """Continuous-linearize, then discretize exactly with the input held
    over the step (the decoupled QP's short stages): q (K, n), ur (K, m),
    dt (K,) -> A (K, n, n), B (K, n, n_keep), c (K, n), the input's other
    columns folded into c.  One `expm_dense` of the (n + m + 1)^2
    augmented matrices, at the JAX package's 8 squarings and order 8."""
    n, m = q.shape[-1], ur.shape[-1]
    Jq, Ju, ct = continuous_affine(f, q, ur)
    M = torch.zeros((q.shape[0], n + m + 1, n + m + 1), dtype=q.dtype,
                    device=q.device)
    M[:, :n, :n] = Jq
    M[:, :n, n:n + m] = Ju
    M[:, :n, -1] = ct
    E = expm_dense((M * dt[:, None, None]).contiguous())
    B_full = E[:, :n, n:n + m]
    c = E[:, :n, -1] + torch.einsum("kij,kj->ki", B_full[..., n_keep:],
                                    ur[:, n_keep:])
    return E[:, :n, :n], B_full[..., :n_keep], c


def linearize_affine_foh(f, q, ur0, urf, dt, n_keep: int):
    """Continuous-linearize at (q, ur0), then discretize exactly with the
    input ramping from ur0 to urf over the step (the decoupled QP's long
    stages): the augmented state [q; u; v; 1] with udot = v, vdot = 0,
    whose (n + 2 m + 1)^2 exponential gives A = Phi_qq, Bf = Phi_qv / dt,
    B0 = Phi_qu - Bf, c = Phi_q1 plus the other input columns.  Returns A
    (K, n, n), B0, Bf (K, n, n_keep), c (K, n)."""
    n, m = q.shape[-1], ur0.shape[-1]
    Jq, Ju, ct = continuous_affine(f, q, ur0)
    dim = n + 2 * m + 1
    M = torch.zeros((q.shape[0], dim, dim), dtype=q.dtype, device=q.device)
    M[:, :n, :n] = Jq
    M[:, :n, n:n + m] = Ju
    M[:, :n, -1] = ct
    M[:, n:n + m, n + m:n + 2 * m] = torch.eye(m, dtype=q.dtype,
                                               device=q.device)
    E = expm_dense((M * dt[:, None, None]).contiguous())
    Phi_qv = E[:, :n, n + m:n + 2 * m]
    Bf_full = Phi_qv / dt[:, None, None]
    B0_full = E[:, :n, n:n + m] - Bf_full
    c = (E[:, :n, -1]
         + torch.einsum("kij,kj->ki", B0_full[..., n_keep:], ur0[:, n_keep:])
         + torch.einsum("kij,kj->ki", Bf_full[..., n_keep:], urf[:, n_keep:]))
    return E[:, :n, :n], B0_full[..., :n_keep], Bf_full[..., :n_keep], c


def linearize_affine_horizon(f, qs, urs, urs_next, dts, n_keep: int):
    """The continuous linearization of a horizon's stages as the
    (n + 2m + 1)^2 augmented matrices of `linearize_horizon_fused`,
    before the ramp block and dt are applied: qs (..., n), urs (..., m)
    -> (M (..., dim, dim), dim) with Jq, Ju and ct in the first n rows
    (`pigeon_tpu.discretize.linearize_affine_horizon`, any leading
    dimensions; `urs_next`, `dts` and `n_keep` are unused there too)."""
    n, m = qs.shape[-1], urs.shape[-1]
    lead = tuple(qs.shape[:-1])
    Jq, Ju, ct = continuous_affine(f, qs.reshape(-1, n), urs.reshape(-1, m))
    dim = n + 2 * m + 1
    M = torch.zeros((Jq.shape[0], dim, dim), dtype=qs.dtype,
                    device=qs.device)
    M[:, :n, :n] = Jq
    M[:, :n, n:n + m] = Ju
    M[:, :n, -1] = ct
    return M.reshape(lead + (dim, dim)), dim


def extract_affine_horizon(E, dts, urs, urs_next, n: int, m: int,
                           n_keep: int):
    """(A, B0, Bf, c) of each stage from the exponentials E (..., dim,
    dim) of the augmented stage matrices: Bf = Phi_qv / dt, B0 = Phi_qu -
    Bf, the input's other columns folded into c
    (`pigeon_tpu.discretize.extract_affine_horizon`, any leading
    dimensions)."""
    Bf_full = E[..., :n, n + m:n + 2 * m] / dts[..., None, None]
    B0_full = E[..., :n, n:n + m] - Bf_full
    c = (E[..., :n, -1]
         + torch.einsum("...ij,...j->...i", B0_full[..., n_keep:],
                        urs[..., n_keep:])
         + torch.einsum("...ij,...j->...i", Bf_full[..., n_keep:],
                        urs_next[..., n_keep:]))
    return E[..., :n, :n], B0_full[..., :n_keep], Bf_full[..., :n_keep], c


def linearize_horizon_fused(f, qs, urs, dts, S: int, n_keep: int,
                            squarings: int = 8, order: int = 8,
                            dense: bool = False):
    """Batched fused exact linearization: ZOH for stages [0, S), FOH for
    [S, T), one exponential per (instance, stage): the structured
    `vanloan`, or with `dense` the stage matrix through `vanloan_dense`
    (what the JAX package does unbatched).

    qs (B, N, n), urs (B, N, m) nodes with N = T+1; dts (B, T).  FOH
    stages ramp urs[t] -> urs[t+1]; ZOH stages hold urs[t] (zero ramp, for
    which Phi_qv is exactly 0).  Returns A (B,T,n,n), B0 (B,T,n,n_keep),
    Bf (B,T,n,n_keep), c (B,T,n)."""
    Bn, T = dts.shape
    n = qs.shape[-1]
    m = urs.shape[-1]
    q = qs[:, :T].reshape(Bn * T, n)
    u = urs[:, :T].reshape(Bn * T, m)
    Jq, Ju, ct = continuous_affine(f, q, u)
    Jq = Jq.reshape(Bn, T, n, n)
    Ju = Ju.reshape(Bn, T, n, m)
    ct = ct.reshape(Bn, T, n)
    foh = (torch.arange(T, device=dts.device) >= S).to(dts.dtype)
    d3 = dts[..., None, None]
    A, Phi_qu, Phi_qv, zcol = (vanloan_dense if dense else vanloan)(
        (Jq * d3).contiguous(), (Ju * d3).contiguous(),
        (ct * dts[..., None])[..., None].contiguous(),
        (foh * dts).contiguous(), squarings, order)
    Bf_full = Phi_qv / d3
    B0_full = Phi_qu - Bf_full
    urs_next = urs[:, 1:]
    c = (zcol[..., 0]
         + torch.einsum("btij,btj->bti", B0_full[..., n_keep:],
                        urs[:, :T, n_keep:])
         + torch.einsum("btij,btj->bti", Bf_full[..., n_keep:],
                        urs_next[..., n_keep:]))
    return A, B0_full[..., :n_keep], Bf_full[..., :n_keep], c
