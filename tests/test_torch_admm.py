"""pigeon_tpu_torch.solver.admm's `solve_qp` and `solve_qp_batched`
(backend "xla") against the JAX package's, at float64, on the soft QPs the
port assembles for a small coupled and a small decoupled fleet (cold
start), with both factor methods and a multi-segment setting in which the
adaptive rho refactors."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.solver import admm as JA
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA

F64 = torch.float64
# short segments and a rho that starts 50 times too stiff: several
# segments per solve, and the adaptive rho drifts and refactors
SEGMENTS = dict(max_iter=400, check_every=10, eps_abs=1e-4, eps_rel=1e-4,
                scaling_iters=4, backend="xla", rho=5.0)
B = 4


def _qps(formulation):
    """The QPs, cold warm starts and soft weights of one cold step."""
    make = (TM.x1_coupled_config if formulation == "coupled"
            else TM.x1_decoupled_config)
    cfg = make(hz=THP(N_short=3, N_long=5), soft=True)
    q0, t0, cols = oval_fleet(B, seed=11)
    q0[:, 4] = np.linspace(-0.3, 0.3, B)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu", dtype=F64)
    carry = TM.init_carry(cfg, B, dtype=F64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    u0 = t64(np.tile([0.02, 100.0, 50.0], (B, 1)))
    qp, warm, aux = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                                  carry, t64(q0), u0, oc, t64(t0))
    return qp, warm, aux.w


@pytest.fixture(scope="module",
                params=[("coupled", "chol"), ("coupled", "ns"),
                        ("decoupled", "chol"), ("decoupled", "ns")],
                ids=lambda p: "-".join(p))
def solved(request):
    formulation, method = request.param
    qp, warm, w = _qps(formulation)
    topts = TSO(factor_method=method, **SEGMENTS)
    jopts = JSO(factor_method=method, **SEGMENTS)

    factors = []
    orig = TA._factor_inv

    def spy(*a, **kw):
        factors.append(1)
        return orig(*a, **kw)

    TA._factor_inv = spy
    try:
        tb = TA.solve_qp_batched(qp, warm, topts, w_soft=w)
        n_batched = len(factors)
        pick = lambda tup, i: type(tup)(*[x[i] for x in tup])
        t1 = [TA.solve_qp(pick(qp, i), pick(warm, i), topts, w_soft=w[i])
              for i in range(B)]
    finally:
        TA._factor_inv = orig

    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jqp, jwarm = JA.QPData(*J(qp)), JA.QPWarmStart(*J(warm))
    jw = jnp.asarray(w.numpy())
    jb = jax.jit(lambda a, b, c: JA.solve_qp_batched(a, b, jopts, w_soft=c))(
        jqp, jwarm, jw)
    j0 = jax.jit(lambda a, b, c: JA.solve_qp(a, b, jopts, w_soft=c))(
        JA.QPData(*[x[0] for x in jqp]), JA.QPWarmStart(*[x[0] for x in jwarm]),
        jw[0])
    return dict(tb=tb, t1=t1, jb=jb, j0=j0, n_batched=n_batched, qp=qp, w=w)


def _close(t, j, what):
    """Both float64 and the same iteration; ADMM amplifies rounding over
    up to 400 iterations: 1e-7 of the array's scale."""
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-7 * max(1.0, np.abs(j).max()),
                               err_msg=what)


def test_batched_matches_jax(solved):
    tb, jb = solved["tb"], solved["jb"]
    np.testing.assert_array_equal(tb.iterations.numpy(),
                                  np.asarray(jb.iterations))
    np.testing.assert_array_equal(tb.converged.numpy(),
                                  np.asarray(jb.converged))
    assert tb.converged.all()
    for name in ("x", "y", "z", "prim_res", "dual_res"):
        _close(getattr(tb, name), getattr(jb, name), name)
    np.testing.assert_allclose(tb.rho_scale.numpy(),
                               np.asarray(jb.rho_scale), rtol=1e-6)


def test_single_matches_jax(solved):
    t0, j0 = solved["t1"][0], solved["j0"]
    assert int(t0.iterations) == int(j0.iterations)
    assert bool(t0.converged) == bool(j0.converged)
    for name in ("x", "y", "z"):
        assert getattr(t0, name).dim() == 1
        _close(getattr(t0, name), getattr(j0, name), name)
    np.testing.assert_allclose(float(t0.rho_scale), float(j0.rho_scale),
                               rtol=1e-6)


def test_adaptive_rho_refactored(solved):
    """More factorizations than one, a rho_scale off 1, and instances
    that finish at different segments (so the masks froze some while
    others went on)."""
    tb = solved["tb"]
    assert solved["n_batched"] >= 2
    assert (tb.rho_scale != 1.0).any()
    assert len(set(tb.iterations.tolist())) >= 2
    assert int(tb.iterations.max()) > SEGMENTS["check_every"]


def test_instance_does_not_depend_on_its_batch(solved):
    """A finished instance is frozen: solved alone, each instance gives
    the batched solve's counts and its iterate to float64 rounding (the
    matrix products of a batch of one and of four sum in other orders;
    an instance that had gone on iterating would differ by ~1e-5)."""
    tb = solved["tb"]
    for i, ti in enumerate(solved["t1"]):
        assert int(ti.iterations) == int(tb.iterations[i])
        for name in ("x", "y", "z", "rho_scale", "prim_res", "dual_res"):
            np.testing.assert_allclose(
                getattr(ti, name).numpy(), getattr(tb, name)[i].numpy(),
                rtol=1e-9, atol=1e-11, err_msg=f"{name}[{i}]")


def test_hard_rows_stay_in_their_box(solved):
    """Rows of infinite weight are projected onto [l, u] exactly, in the
    shrink prox as in the box projection."""
    qp, w, z = solved["qp"], solved["w"], solved["tb"].z
    hard = torch.isinf(w)
    tol = 1e-12 * torch.clamp(z.abs(), min=1.0)
    assert ((z >= qp.l - tol) | ~hard).all()
    assert ((z <= qp.u + tol) | ~hard).all()


def test_unported_solver_options_raise():
    qp, warm, w = _qps("decoupled")
    for change in (dict(backend="pallas"),):
        opts = dataclasses.replace(TSO(**SEGMENTS), **change)
        with pytest.raises(NotImplementedError):
            TA.solve_qp_batched(qp, warm, opts, w_soft=w)


def _ns_factors(iters, bulk):
    """The K^-1 of the scaled soft coupled QPs (a rho of 0.1, 1e2 on
    every fifth row) by Newton-Schulz with `bulk` bf16 steps of `iters`,
    in both packages, float64, and the exact inverse."""
    qp, _, _ = _qps("coupled")
    (Pb, _, Ab, _, _), _, _, _ = TA.ruiz(qp, 4)
    rho = torch.full_like(qp.l, 0.1)
    rho[:, ::5] = 1e2
    opts = dict(factor_method="ns", ns_iters=iters, ns_bf16_iters=bulk)
    port = TA._factor_inv(Pb, Ab, rho, 1e-6, TSO(**opts))
    J = lambda t: jnp.asarray(t.numpy())
    jax_ = jax.vmap(lambda P, A, r: JA._factor_inv(
        P, A, r, 1e-6, JSO(**opts)))(J(Pb), J(Ab), J(rho))
    K = (Ab.transpose(-1, -2) * rho[:, None, :]) @ Ab + 1e-6 * torch.eye(
        Pb.shape[-1], dtype=Pb.dtype)
    K = K + (Pb if Pb.dim() == 3 else torch.diag_embed(Pb))
    return port.numpy(), np.asarray(jax_), torch.linalg.inv(K).numpy()


@pytest.mark.parametrize("iters,bulk", [(12, 12), (40, 6)],
                         ids=["all_bf16", "bf16_then_fp32"])
def test_ns_bf16_bulk_matches_jax(iters, bulk):
    """`ns_bf16_iters` (JAX admm.py:180-197): bf16 operands and results
    in each bulk step, products summed in float32, then float64 steps.
    All in bf16, the port's factor lies within bf16 resolution (2^-8 of
    the scale) of the JAX package's and further than that from the
    float64 Newton-Schulz of as many steps; with float64 steps after it
    both reach the exact inverse to 1e-9 of its scale."""
    port, jax_, exact = _ns_factors(iters, bulk)
    scale = np.abs(exact).max()
    assert np.isfinite(port).all()
    if bulk == iters:
        fp64 = _ns_factors(iters, 0)[0]
        d_jax = np.abs(port - jax_).max()
        assert d_jax <= 2.0 ** -8 * scale, d_jax / scale
        assert np.abs(port - fp64).max() > d_jax
    else:
        np.testing.assert_allclose(port, exact, rtol=0, atol=1e-9 * scale)
        np.testing.assert_allclose(jax_, exact, rtol=0, atol=1e-9 * scale)


def test_hard_qp_without_weights_matches_jax():
    """w_soft=None takes the box projection; a scalar-P (diagonal) QP."""
    rng = np.random.default_rng(2)
    n, m = 6, 9
    P = rng.uniform(0.5, 2.0, n)
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l, u = -rng.uniform(0.1, 1.0, m), rng.uniform(0.1, 1.0, m)
    l[0] = u[0] = 0.05                                  # an equality row
    opts = dict(max_iter=300, check_every=25, scaling_iters=3)
    ts = TA.solve_qp(TA.QPData(*[t64(a) for a in (P, q, A, l, u)]), None,
                     TSO(**opts))
    js = JA.solve_qp(JA.QPData(*[jnp.asarray(a) for a in (P, q, A, l, u)]),
                     None, JSO(**opts))
    assert int(ts.iterations) == int(js.iterations)
    assert bool(ts.converged) and bool(js.converged)
    for name in ("x", "y", "z"):
        _close(getattr(ts, name), getattr(js, name), name)


def test_non_finite_qp_gives_nan_not_an_exception():
    """A QP with non-finite data makes K indefinite: the factor is NaN, as
    the JAX package's Cholesky gives it, the solve spends its budget and
    reports not converged (the MPC step's NaN fallback takes over)."""
    rng = np.random.default_rng(3)
    n, m = 4, 6
    P = rng.uniform(0.5, 2.0, n)
    P[1] = np.nan
    q = rng.normal(size=n)
    A = rng.normal(size=(m, n))
    l, u = -np.ones(m), np.ones(m)
    opts = dict(max_iter=50, check_every=25, scaling_iters=0)
    ts = TA.solve_qp(TA.QPData(*[t64(a) for a in (P, q, A, l, u)]), None,
                     TSO(**opts))
    js = JA.solve_qp(JA.QPData(*[jnp.asarray(a) for a in (P, q, A, l, u)]),
                     None, JSO(**opts))
    assert not torch.isfinite(ts.x).any() and not np.isfinite(js.x).any()
    assert not bool(ts.converged) and not bool(js.converged)
    assert int(ts.iterations) == int(js.iterations) == 50
