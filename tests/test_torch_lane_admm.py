"""pigeon_tpu_torch.solver.lane_admm against pigeon_tpu.solver.lane_admm:
the plain versions of the Cholesky-inverse and ADMM-iteration kernels
against the TPU kernels in interpret mode (float32, full main-path sizes
n=30, m=124), and the whole lane solve on QPs from the slice."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.config import SolverOptions as JSolverOptions
from pigeon_tpu.solver import admm as JA
from pigeon_tpu.solver import lane_admm as JL
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch.config import SolverOptions
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import lane_admm as TL

BENCH = dict(max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
             backend="lanes", scaling_iters=2, pallas_check_inner=10)


def _slice_qp(B, hz=None):
    """QPs, warm starts and soft weights of one cold step of an oval fleet
    (the port's pre-solve at float64); `hz` = (N_short, N_long) overrides
    the horizon."""
    q0, t0, cols = oval_fleet(B)
    cfg = dataclasses.replace(TM.x1_coupled_config(soft=True),
                              solver=SolverOptions(**BENCH))
    if hz is not None:
        cfg = dataclasses.replace(cfg, hz=dataclasses.replace(
            cfg.hz, N_short=hz[0], N_long=hz[1]))
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = TM.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, warm, aux = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                                  carry, t64(q0), torch.zeros((B, 3),
                                                              dtype=torch.float64),
                                  oc, t64(t0))
    return cfg, qp, warm, aux.w


@pytest.fixture(scope="module")
def iter_inputs():
    """The lane-layout operands the slice hands the iteration kernel for a
    130-instance fleet: two groups, the second ragged."""
    cfg, qp, warm, w = _slice_qp(130)
    seen = {}
    orig = TL.admm_iterations

    def spy(*args, **kw):
        seen.setdefault("call", (args, kw))
        return orig(*args, **kw)

    TL.admm_iterations = spy
    try:
        TL.solve_lanes_batched(qp, warm, cfg.solver, w_soft=w)
    finally:
        TL.admm_iterations = orig
    return seen["call"]


def _jax_lanes(ops, n_pad, m_pad, Bp):
    """The same operands in the TPU kernel's padded lane layout."""
    (Kinv, A, q, l, u, rho, cap, x, z, y, E, PuD, qu, invDc) = [
        o.numpy() for o in ops]
    n, B = q.shape
    m = l.shape[0]

    def vec(v, length, fill=0.0):
        out = np.full((length, Bp), fill, np.float32)
        out[:v.shape[0], :B] = v
        return out

    def mat(M, r, c):
        out = np.zeros((r, c, Bp), np.float32)
        out[:M.shape[0], :M.shape[1], :B] = M
        return out

    Kinv_l = mat(Kinv, n_pad, n_pad)
    for j in range(n_pad):
        Kinv_l[j, j, B:] = 1.0
        if j >= n:
            Kinv_l[j, j, :] = 1.0
    A_l = mat(A, m_pad, n_pad)
    return [jnp.asarray(a) for a in (
        Kinv_l, A_l, np.ascontiguousarray(np.swapaxes(A_l, 0, 1)),
        vec(q, n_pad), vec(l, m_pad), vec(u, m_pad), vec(rho, m_pad, 1.0),
        vec(cap, m_pad, np.inf), vec(x, n_pad), vec(z, m_pad),
        vec(y, m_pad), vec(E, m_pad, 1.0), mat(PuD, n_pad, n_pad),
        vec(qu, n_pad), vec(invDc, n_pad))]


@pytest.mark.parametrize("check", [10, 0])
def test_admm_iterations_plain_matches_tpu_kernel(iter_inputs, check):
    args, kw = iter_inputs
    ops = args[:14]
    n_iters, sigma, alpha = args[14:17]
    n, B = ops[2].shape
    m = ops[3].shape[0]
    assert (n, m, B) == (30, 124, 130)
    eps = dict(eps_abs=kw["eps_abs"], eps_rel=kw["eps_rel"])
    x, z, y, st = TL.admm_iterations(*ops, n_iters, sigma, alpha,
                                     check=check, **eps)
    jx, jz, jy, jst = JL.admm_iterations_lanes(
        *_jax_lanes(ops, 32, 128, 256), n_iters=n_iters, sigma=sigma,
        alpha=alpha, check=check, interpret=True, **eps)
    executed = np.asarray(jst)[6, :B]
    np.testing.assert_array_equal(st[6].numpy(), executed)
    if check:
        # the group exit: each group stops as a whole, and at least one
        # group stops early
        assert len(set(executed[:128])) == 1
        assert executed.min() < n_iters
    # float32 iterates: 1e-5 absolute, relative to the array's largest
    # entry where that exceeds 1 (the duals y reach ~5)
    for o, r, rows in ((x, jx, n), (z, jz, m), (y, jy, m)):
        r = np.asarray(r)[:rows, :B]
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(r).max()))
    # residuals are differences of float32 values as large as max|Ax|,
    # max|z|, max|Px|, max|A'y| (rows 2-5)
    jst = np.asarray(jst)[:6, :B]
    np.testing.assert_allclose(st[:6].numpy(), jst, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(jst[2:]).max()))


def _slice_kkt(B, hz=None):
    """The KKT matrices (B, n, n) the slice's lane solve factors first."""
    cfg, qp, warm, w = _slice_qp(B, hz)
    seen = {}
    orig = TL.chol_inverse

    def spy(K, *args, **kw):
        seen.setdefault("K", K)
        return orig(K, *args, **kw)

    TL.chol_inverse = spy
    try:
        TL.solve_lanes_batched(qp, warm, cfg.solver, w_soft=w)
    finally:
        TL.chol_inverse = orig
    return seen["K"].numpy()


def _chol_inverse_matches_tpu_kernel(K):
    B, n, _ = K.shape
    n_pad = 32
    K_l = np.zeros((n_pad, n_pad, 128), np.float32)
    K_l[:n, :n, :B] = np.moveaxis(K, 0, -1)
    for j in range(n_pad):
        K_l[j, j, B:] = 1.0
        if j >= n:
            K_l[j, j, :] = 1.0
    ref = np.moveaxis(np.asarray(JL.chol_inverse_lanes(
        jnp.asarray(K_l), n, polish=1, interpret=True))[:n, :n, :B], -1, 0)
    out = TL.chol_inverse(torch.as_tensor(K), 1).numpy()
    # float32: 1e-4 of each instance's largest entry
    scale = np.abs(ref).max(axis=(1, 2), keepdims=True)
    assert np.all(np.abs(out - ref) <= 1e-4 * scale)
    # it inverts (sigma = 1e-6 on the Ruiz-scaled diagonal), and stays
    # symmetric to rounding
    eye = np.eye(n)
    assert np.abs(np.einsum("bij,bjk->bik", K.astype(np.float64),
                            out.astype(np.float64)) - eye).max() < 1e-3
    assert np.all(np.abs(out - out.transpose(0, 2, 1)) <= 1e-5 * scale)


def test_chol_inverse_plain_matches_tpu_kernel():
    """The KKT matrices of an 8-vehicle slice step (n=30; the kernel's
    128-lane block is ragged)."""
    _chol_inverse_matches_tpu_kernel(_slice_kkt(8))


def test_chol_inverse_plain_matches_tpu_kernel_short_horizon():
    """The same on the 12-stage horizon (4, 8): n = 24, so the padding to
    32 is 8 identity rows."""
    K = _slice_kkt(8, (4, 8))
    assert K.shape == (8, 24, 24)
    _chol_inverse_matches_tpu_kernel(K)


@pytest.mark.parametrize("n", [30, 24, 1, 32])
def test_chol_inverse_plan_takes_the_path_shapes(n):
    """2 instances a block, each with K padded to 32 x 32 (rows 33 floats
    apart) and two 32 x 36-float tiles, static shared memory within 48
    KB."""
    plan = TL.chol_inverse_plan(n)
    assert plan == (2, 4 * 2 * (32 * 33 + 2 * 32 * 36)) == (2, 26880)
    assert plan[1] <= 48 * 1024


@pytest.mark.parametrize("n", [0, 33, 64])
def test_chol_inverse_plan_refuses_other_sizes(n):
    with pytest.raises(ValueError, match="n <= 32"):
        TL.chol_inverse_plan(n)


def test_wrappers_reject_bad_arguments():
    K = torch.eye(4).expand(2, 4, 4).contiguous()
    with pytest.raises(ValueError):
        TL.chol_inverse(K[:, :3])
    with pytest.raises(TypeError):
        TL.chol_inverse(K.to(torch.int32))


def test_cold_start_matches_jax():
    """The batched cold start is the JAX package's per-instance cold start
    stacked over the fleet."""
    cfg, qp, warm, w = _slice_qp(2)
    cold = TA.cold_start(qp)
    ref = JA.cold_start(JA.QPData(*[jnp.asarray(a.numpy()[0]) for a in qp]))
    for name in JA.QPWarmStart._fields:
        a, r = getattr(cold, name).numpy(), np.asarray(getattr(ref, name))
        assert a.shape == (2,) + r.shape and a.dtype == r.dtype, name
        np.testing.assert_array_equal(a, np.broadcast_to(r, a.shape))
    # on a cold carry the step's own warm start is the cold start
    for name in JA.QPWarmStart._fields:
        np.testing.assert_array_equal(getattr(warm, name).numpy(),
                                      getattr(cold, name).numpy())


@pytest.mark.parametrize("iters", [(150, 150), (300, 30)])
def test_solve_lanes_batched_matches_jax(iters):
    """One lane block (8 instances) of slice QPs, cold; (300, 30) runs up
    to ten segments with adaptive rho and refactors."""
    cfg, qp, warm, w = _slice_qp(8)
    opts = dict(BENCH, max_iter=iters[0], check_every=iters[1])
    sol = TL.solve_lanes_batched(qp, warm, SolverOptions(**opts), w_soft=w)
    jqp = JA.QPData(*[jnp.asarray(a.numpy()) for a in qp])
    jwarm = JA.QPWarmStart(*[jnp.asarray(a.numpy()) for a in warm])
    ref = JL.solve_lanes_batched(jqp, jwarm, JSolverOptions(**opts),
                                 jnp.asarray(w.numpy()))
    np.testing.assert_array_equal(sol.iterations.numpy(),
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(sol.converged.numpy(),
                                  np.asarray(ref.converged))
    for name in ("x", "rho_scale"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # the residuals come from float32 kernel statistics of vectors with
    # entries up to ~10 (see the iteration-kernel test)
    for name in ("prim_res", "dual_res"):
        np.testing.assert_allclose(getattr(sol, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
