"""pigeon_tpu_torch.solver.pallas_admm's plain version (what the
`admm_dense` CUDA kernel computes) against the JAX package's dense ADMM
kernel in interpret mode at float32, 5 instances in tiles of 2 (the last
tile holds one instance), at the shapes of horizon (2, 3): n=70, m=104.

- Well-conditioned random QPs (tests/test_pallas_admm.py's): a fixed
  segment, the early exit per tile and a remainder block, within 2e-4,
  the tolerance tests/test_pallas_admm.py holds the JAX kernel to; and
  the same with a dense P (the kernel's dense-P mode: P x in the
  statistics from the dense unscaled P).
- The Ruiz-scaled sparse QPs of a 5-vehicle fleet with their banded K^-1:
  the stiff equality rows (rho_eq = 1e3 rho) amplify float32 rounding, so
  both float32 implementations sit ~1e-3 of their scale from the float64
  iteration; the plain version must be no further from it than twice the
  JAX kernel is, and exit at the JAX kernel's checks to within one."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, random_admm_ops, t64
from pigeon_tpu.solver.pallas_admm import admm_iterations as j_admm
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import pallas_admm as TP

B, TILE, CHECK = 5, 2, 10
SIGMA, ALPHA = 1e-6, 1.6
_random_ops = functools.partial(random_admm_ops, B, SIGMA)


@pytest.fixture(scope="module")
def ops():
    """float32 numpy operands of one segment: the Ruiz-scaled QPs, per-row
    rho, the banded K^-1, a warm start and the scalings."""
    cfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3))
    q0, t0, cols = oval_fleet(B, seed=31)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = TM.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                             carry, t64(q0), t64(np.zeros((B, 3))), oc,
                             t64(t0))
    (Pb, qb, Ab, lb, ub), D, E, c = TA.ruiz(qp, 4)
    rho = torch.where((qp.u - qp.l) < 1e-10, 100.0, 0.1).to(torch.float64)
    Kinv = TA._factor_inv(Pb, Ab, rho, SIGMA,
                          TSO(factor_method="banded"), TM._banded_plan_for(
                              TM.x1_coupled_config(
                                  hz=THP(N_short=2, N_long=3),
                                  solver=TSO(factor_method="banded"))))
    rng = np.random.default_rng(4)
    n, m = qb.shape[1], lb.shape[1]
    warm = [0.1 * rng.normal(size=(B, n)), 0.1 * rng.normal(size=(B, m)),
            0.1 * rng.normal(size=(B, m))]
    f = lambda t: np.asarray(t, np.float32)
    return dict(mats=[f(t) for t in (Kinv, Ab, qb, lb, ub, rho)],
                warm=[f(w) for w in warm],
                scalings=[f(t) for t in (D, E, c, qp.P_diag, qp.q)])


def _run(ops, n_iters, check, dense_P=False):
    ref = j_admm(*[jnp.asarray(a) for a in ops["mats"] + ops["warm"]],
                 n_iters, SIGMA, ALPHA, tile=TILE, interpret=True,
                 scalings=tuple(jnp.asarray(a) for a in ops["scalings"]),
                 check=check, eps_abs=1e-3, eps_rel=1e-3, dense_P=dense_P)
    T = lambda a: torch.as_tensor(a)
    out = TP.admm_iterations(
        *[T(a) for a in ops["mats"] + ops["warm"]], n_iters, SIGMA, ALPHA,
        tile=TILE, scalings=tuple(T(a) for a in ops["scalings"]),
        check=check, eps_abs=1e-3, eps_rel=1e-3, dense_P=dense_P)
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def _close(o, r, what):
    np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-4, err_msg=what)


@pytest.mark.parametrize("n_iters,check", [(30, 0), (200, CHECK), (45, CHECK)],
                         ids=["fixed", "early_exit", "remainder"])
def test_plain_matches_jax_kernel(n_iters, check):
    _held_to_jax(*_run(_random_ops(), n_iters, check), n_iters, check)


@pytest.mark.parametrize("n_iters,check", [(30, 0), (200, CHECK)],
                         ids=["fixed", "early_exit"])
def test_plain_dense_P_matches_jax_kernel(n_iters, check):
    """The dense-P mode (the JAX kernel's `dense_P`, :190 and :311): the
    statistics' P x_u is x_bar' (D P_u), a matvec with the dense P."""
    ops = _random_ops(seed=3, dense_P=True)
    assert ops["scalings"][3].shape == (B, 70, 70)
    ref, out = _run(ops, n_iters, check, dense_P=True)
    _held_to_jax(ref, out, n_iters, check)
    # the dense P is in the statistics: the diagonal mode differs
    _, diag = _run(dict(ops, scalings=ops["scalings"][:3]
                        + [np.ascontiguousarray(np.diagonal(
                            ops["scalings"][3], axis1=1, axis2=2)),
                           ops["scalings"][4]]), n_iters, check)
    assert np.abs(diag[3][:, 4] - out[3][:, 4]).max() > 1e-2


def _held_to_jax(ref, out, n_iters, check):
    for name, o, r in zip(("x", "z", "y"), out[:3], ref[:3]):
        assert o.dtype == np.float32 and o.shape == r.shape
        _close(o, r, name)
    so, sr = out[3], ref[3]
    assert so.shape == (B, 8)
    # statistics: the residuals to the magnitudes they are differences of
    np.testing.assert_allclose(so[:, 2:6], sr[:, 2:6], rtol=2e-4, atol=2e-4)
    scale_p = np.maximum(sr[:, 2], sr[:, 3]).max()
    scale_d = np.maximum(sr[:, 4], sr[:, 5]).max()
    assert np.abs(so[:, 0] - sr[:, 0]).max() <= 2e-4 * max(scale_p, 1.0)
    assert np.abs(so[:, 1] - sr[:, 1]).max() <= 2e-4 * max(scale_d, 1.0)
    np.testing.assert_array_equal(so[:, 6], sr[:, 6])
    np.testing.assert_array_equal(so[:, 7], 0.0)
    executed = so[:, 6]
    if check == 0:
        assert (executed == n_iters).all()
    else:
        # one count per tile of 2; the ragged last tile (one instance)
        # exits on its own instance
        for t0 in range(0, B, TILE):
            assert len(set(executed[t0:t0 + TILE])) == 1
        assert (executed <= n_iters).all()
        assert (executed % CHECK == 0).all() or n_iters % CHECK


def test_early_exit_differs_by_tile():
    """The tiles stop at different checks: the exit is per tile."""
    _, out = _run(_random_ops(), 200, CHECK)
    assert len(set(out[3][:, 6].tolist())) >= 2
    assert (out[3][:, 6] < 200).any()


@pytest.mark.parametrize("n_iters,check", [(30, 0), (200, CHECK)],
                         ids=["fixed", "early_exit"])
def test_mpc_qps_within_float32_rounding(ops, n_iters, check):
    ref, out = _run(ops, n_iters, check)
    T64 = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    exact = TP.admm_iterations(
        *[T64(a) for a in ops["mats"] + ops["warm"]], n_iters, SIGMA,
        ALPHA, tile=TILE, scalings=tuple(T64(a) for a in ops["scalings"]),
        check=check, eps_abs=1e-3, eps_rel=1e-3)
    for name, o, r, e in zip(("x", "z", "y"), out, ref, exact):
        e = e.numpy()
        d_jax = np.abs(r - e).max()
        d_port = np.abs(o - e).max()
        assert d_port <= 2.0 * d_jax + 1e-6 * np.abs(e).max(), (
            name, d_port, d_jax)
    assert np.abs(out[3][:, 6] - ref[3][:, 6]).max() <= CHECK

