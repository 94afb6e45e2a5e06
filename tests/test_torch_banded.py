"""pigeon_tpu_torch.solver.banded against pigeon_tpu.solver.banded at
float64: the stage plan, the plain block-Cholesky stage recursion (the
plain version of the `banded_chol` kernel) against `_chol_factor_impl`,
and the banded K^-1 against the JAX package's and against the dense
inverse, on the Ruiz-scaled sparse QPs of a small fleet (horizon (2, 3):
n=70, m=104, 6 blocks of 13); the block cyclic reduction
(`solve_block_tridiag_cr`, method "cr") on tests/test_banded_cr.py's
random systems and on the same QPs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.solver import banded as JB
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import banded as TB

F64 = torch.float64
SIGMA = 1e-6


@pytest.mark.parametrize("hz", [(2, 3), (5, 10), (4, 8)], ids=str)
def test_stage_plan_matches(hz):
    jp = JB.coupled_stage_plan(JHP(N_short=hz[0], N_long=hz[1]))
    tp = TB.coupled_stage_plan(THP(N_short=hz[0], N_long=hz[1]))
    np.testing.assert_array_equal(tp[0], jp[0])
    assert tp[1:] == jp[1:]
    if hz == (5, 10):
        assert tp[1:] == (193, 13, 16)


@pytest.fixture(scope="module")
def scaled():
    """Ruiz-scaled P, A and the per-row rho of one cold step's sparse QPs
    (B=4), with the stage blocks of K."""
    B = 4
    cfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3))
    q0, t0, cols = oval_fleet(B, seed=12)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu", dtype=F64)
    carry = TM.init_carry(cfg, B, dtype=F64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                             carry, t64(q0), t64(np.zeros((B, 3))), oc,
                             t64(t0))
    (Pb, _, Ab, _, _), _, _, _ = TA.ruiz(qp, 4)
    is_eq = (qp.u - qp.l) < 1e-10
    rho = torch.where(is_eq, 100.0, 0.1).to(F64)
    # a second rho level, as after an adaptive-rho refactor
    rho = rho * torch.tensor([1.0, 3.0, 0.2, 50.0], dtype=F64)[:, None]
    plan = TB.coupled_stage_plan(cfg.hz)
    return dict(Pb=Pb, Ab=Ab, rho=rho, plan=plan)


def _blocks(Pb, Ab, rho, plan):
    slots, n, bw, nb = plan
    K = (Ab.transpose(-1, -2) * rho[:, None, :]) @ Ab
    K = K + torch.diag_embed(Pb + SIGMA)
    Kx = torch.nn.functional.pad(K, (0, 1, 0, 1))
    Kx[:, n, n] = 1.0
    s = torch.as_tensor(slots, dtype=torch.int64)
    Kd = Kx[:, s[:, :, None], s[:, None, :]]
    Ks = torch.cat([torch.zeros_like(Kd[:, :1]),
                    Kx[:, s[1:, :, None], s[:-1, None, :]]], dim=1)
    return K, Kd, Ks


def test_plain_chol_factor_matches_jax(scaled):
    _, Kd, Ks = _blocks(scaled["Pb"], scaled["Ab"], scaled["rho"],
                        scaled["plan"])
    Linv, S = TB.chol_factor_plain(Kd, Ks)
    jLinv, jS = jax.vmap(JB._chol_factor_impl)(jnp.asarray(Kd.numpy()),
                                               jnp.asarray(Ks.numpy()))
    for o, r in ((Linv, jLinv), (S, jS)):
        r = np.asarray(r)
        np.testing.assert_allclose(o.numpy(), r, rtol=0,
                                   atol=1e-9 * np.abs(r).max())
    # the wrapper takes the plain version for a CPU tensor
    Lw, Sw = TB.chol_factor(Kd, Ks)
    assert torch.equal(Lw, Linv) and torch.equal(Sw, S)


def test_chol_factor_floors_pivots():
    """A singular last stage block: the pivot floor keeps the factor
    finite, as the JAX package's unrolled Cholesky does."""
    rng = np.random.default_rng(0)
    Kd = rng.normal(size=(2, 3, 5, 5))
    Kd = Kd @ np.swapaxes(Kd, -1, -2) + 5.0 * np.eye(5)
    Ks = 0.01 * rng.normal(size=(2, 3, 5, 5))
    Ks[:, 0] = 0.0
    Kd[:, 2, 2, :] = Kd[:, 2, :, 2] = 0.0
    Ks[:, 2, 2, :] = 0.0
    Linv, S = TB.chol_factor_plain(t64(Kd), t64(Ks))
    jLinv, jS = jax.vmap(JB._chol_factor_impl)(jnp.asarray(Kd),
                                               jnp.asarray(Ks))
    assert torch.isfinite(Linv).all()
    np.testing.assert_allclose(Linv[:, 2, 2, 2].numpy(), 1e6, rtol=1e-12)
    np.testing.assert_allclose(Linv.numpy(), np.asarray(jLinv), rtol=1e-9)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-9,
                               atol=1e-12)


def test_factor_inv_banded_matches_jax_and_dense(scaled):
    Pb, Ab, rho = scaled["Pb"], scaled["Ab"], scaled["rho"]
    slots, n, bw, nb = scaled["plan"]
    K, _, _ = _blocks(Pb, Ab, rho, scaled["plan"])
    Kinv = TB.factor_inv_banded(Pb, Ab, rho, SIGMA, slots, n, bw, nb)
    ref = jax.vmap(lambda P, A, r: JB.factor_inv_banded(
        P, A, r, SIGMA, slots, n, bw, nb))(
        *[jnp.asarray(t.numpy()) for t in (Pb, Ab, rho)])
    ref = np.asarray(ref)
    dense = torch.linalg.inv(K).numpy()
    scale = np.abs(dense).max(axis=(1, 2), keepdims=True)
    assert Kinv.shape == (4, n, n)
    np.testing.assert_allclose(Kinv.numpy() / scale, ref / scale, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(Kinv.numpy() / scale, dense / scale, rtol=0,
                               atol=1e-9)
    # the plain route (the single-instance solve's) gives the same K^-1
    plain = TB.factor_inv_banded(Pb, Ab, rho, SIGMA, slots, n, bw, nb,
                                 kernel=False)
    assert torch.equal(plain, Kinv)


def test_solver_factor_banded_matches_chol(scaled):
    """`admm._factor_inv` with factor_method "banded" and the plan, against
    the dense Cholesky inverse of the same K."""
    from pigeon_tpu_torch.config import SolverOptions
    Pb, Ab, rho = scaled["Pb"], scaled["Ab"], scaled["rho"]
    kb = TA._factor_inv(Pb, Ab, rho, SIGMA,
                        SolverOptions(factor_method="banded"),
                        scaled["plan"])
    kc = TA._factor_inv(Pb, Ab, rho, SIGMA, SolverOptions())
    scale = kc.abs().amax()
    assert float((kb - kc).abs().max() / scale) < 1e-9


def test_unported_factor_options_raise(scaled):
    """A tp axis name outside a sharded step is unbound (NameError, as
    JAX raises; tests/test_torch_banded_tp.py runs the bound axis on a
    gloo world); an unknown method is a ValueError."""
    Pb, Ab, rho = scaled["Pb"], scaled["Ab"], scaled["rho"]
    slots, n, bw, nb = scaled["plan"]
    with pytest.raises(NameError, match="unbound axis name: tp"):
        TB.factor_inv_banded(Pb, Ab, rho, SIGMA, slots, n, bw, nb,
                             tp_axis="tp")
    with pytest.raises(ValueError):
        TB.factor_inv_banded(Pb, Ab, rho, SIGMA, slots, n, bw, nb,
                             method="lu")


@pytest.mark.parametrize("bw, build", [(13, 13), (14, 16), (15, 16),
                                       (16, 16), (1, 16), (12, 16)])
def test_chol_build_picks_the_compiled_width(bw, build):
    """The banded Cholesky kernel's builds: bw = 13 (the sparse QP's
    stages) fixed at compile time, any other bw <= 16 padded."""
    assert TB.chol_build(bw) == build


@pytest.mark.parametrize("bw", [0, 17, 32])
def test_chol_build_refuses_wider_blocks(bw):
    with pytest.raises(ValueError):
        TB.chol_build(bw)


def test_chol_factor_cpu_takes_any_width():
    """Only the card's kernel is limited to bw <= 16; a CPU tensor takes
    the plain version at any width."""
    rng = np.random.default_rng(3)
    Kd = rng.normal(size=(2, 2, 17, 17))
    Kd = Kd @ np.swapaxes(Kd, -1, -2) + 17.0 * np.eye(17)
    Ks = np.zeros_like(Kd)
    Linv, S = TB.chol_factor(t64(Kd), t64(Ks))
    ref = np.linalg.inv(np.linalg.cholesky(Kd))
    np.testing.assert_allclose(Linv.numpy(), ref, rtol=1e-10, atol=1e-12)
    assert not S.any()


# ---------------------------------------------------------------------------
# Block cyclic reduction
# ---------------------------------------------------------------------------

def _random_block_tridiag(B, nb, bw, k, seed):
    """tests/test_banded_cr.py's diagonally dominant symmetric
    block-tridiagonal systems (so SPD), a batch of B."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(B, nb, bw, bw)) * 0.3
    L[:, 0] = 0.0
    D = rng.normal(size=(B, nb, bw, bw))
    D = (D + np.swapaxes(D, -1, -2)) / 2 + 2.0 * bw * np.eye(bw)
    return D, L, rng.normal(size=(B, nb, bw, k))


@pytest.mark.parametrize("nb", [1, 2, 3, 7, 16])
def test_cr_solve_matches_jax(nb):
    """The batched cyclic reduction against the JAX package's (one
    instance at a time) at float64, levels padded to 2^q - 1 stages."""
    D, L, F = _random_block_tridiag(2, nb, 5, 7, seed=nb)
    x = TB.solve_block_tridiag_cr(t64(D), t64(L), t64(F))
    assert x.shape == (2, nb, 5, 7)
    ref = np.asarray(jax.jit(jax.vmap(JB.solve_block_tridiag_cr))(
        jnp.asarray(D), jnp.asarray(L), jnp.asarray(F)))
    for b in range(2):
        np.testing.assert_allclose(x[b].numpy(), ref[b], rtol=0,
                                   atol=1e-12 * np.abs(ref[b]).max())


def test_factor_inv_banded_cr_matches_jax_and_dense(scaled):
    """factor_inv_banded(method="cr") (cyclic reduction of K X = I and one
    Newton polish) against the JAX package's and the dense inverse; and
    `_factor_inv` with factor "banded_cr" and the plan takes it."""
    from pigeon_tpu_torch.config import SolverOptions
    Pb, Ab, rho = scaled["Pb"], scaled["Ab"], scaled["rho"]
    slots, n, bw, nb = scaled["plan"]
    K, _, _ = _blocks(Pb, Ab, rho, scaled["plan"])
    Kinv = TB.factor_inv_banded(Pb, Ab, rho, SIGMA, slots, n, bw, nb,
                                method="cr")
    ref = np.asarray(jax.jit(jax.vmap(lambda P, A, r: JB.factor_inv_banded(
        P, A, r, SIGMA, slots, n, bw, nb, method="cr")))(
        *[jnp.asarray(t.numpy()) for t in (Pb, Ab, rho)]))
    dense = torch.linalg.inv(K).numpy()
    scale = np.abs(dense).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(Kinv.numpy() / scale, ref / scale, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(Kinv.numpy() / scale, dense / scale, rtol=0,
                               atol=1e-9)
    via = TA._factor_inv(Pb, Ab, rho, SIGMA,
                         SolverOptions(factor_method="banded_cr"),
                         scaled["plan"])
    assert torch.equal(via, Kinv)
