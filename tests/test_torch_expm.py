"""pigeon_tpu_torch.discretize's dense route against the JAX package:
`expm_dense` against `expm_fixed` and the block-diagonal packed chain
(`_expm_stage_packed_impl`, whose TPU branch is the chain kernel and whose
CPU branch is the same chain in XLA) for the stage-matrix sizes of the two
formulations, and `vanloan_dense` against the structured `vanloan`.  On
the CPU `expm_dense` runs its plain version (`expm_fixed`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import t64
from pigeon_tpu import discretize as JZ
from pigeon_tpu import dynamics as JD
from pigeon_tpu.config import x1_params
from pigeon_tpu_torch import discretize as TZ
from pigeon_tpu_torch import dynamics as TD

VEH = x1_params()


def _stage_inputs(B, T, n, m, seed=0, dt_scale=0.05):
    rng = np.random.default_rng(seed)
    P0 = rng.normal(size=(B, T, n, n)) * dt_scale
    Cu0 = rng.normal(size=(B, T, n, m)) * dt_scale
    cc0 = rng.normal(size=(B, T, n, 1)) * dt_scale
    rr = (rng.uniform(0.0, 0.2, size=(B, T))
          * rng.integers(0, 2, size=(B, T)))
    return P0, Cu0, cc0, rr


@pytest.mark.parametrize("T,d", [(15, 19), (30, 17)],
                         ids=["coupled", "decoupled"])
def test_expm_dense_matches_jax_fp64(T, d):
    """Float64, the same chain: rounding only."""
    M = np.random.default_rng(d).normal(size=(T, d, d)) * 0.2
    out = TZ.expm_dense(t64(M), 4, 6)
    ref = jax.vmap(lambda a: JZ.expm_fixed(a, squarings=4, order=6))(
        jnp.asarray(M))
    packed = JZ._expm_stage_packed_impl(jnp.asarray(M), 4, 6, "highest")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12,
                               atol=1e-13)
    np.testing.assert_allclose(out.numpy(), np.asarray(packed), rtol=1e-12,
                               atol=1e-13)


@pytest.mark.parametrize("T,d", [(15, 19), (30, 17)],
                         ids=["coupled", "decoupled"])
def test_expm_dense_matches_packed_chain_fp32(T, d):
    """Float32 (the kernel's type): the packed 128 x 128 chain sums each
    block's products among exact zeros, so the two agree to float32
    rounding amplified by the four squarings."""
    M = (np.random.default_rng(d + 1).normal(size=(T, d, d)) * 0.2
         ).astype(np.float32)
    out = TZ.expm_dense(torch.as_tensor(M), 4, 6)
    assert out.dtype == torch.float32
    packed = JZ._expm_stage_packed_impl(jnp.asarray(M), 4, 6, "highest")
    np.testing.assert_allclose(out.numpy(), np.asarray(packed), rtol=3e-5,
                               atol=3e-6)


@pytest.mark.parametrize("n", [6, 4], ids=["tracking", "lateral"])
def test_vanloan_dense_matches_structured(n):
    """Both routes compute the order-6 Taylor polynomial of the same
    matrix: equal to rounding at float64.  On ZOH stages (rr = 0) the
    structured form gives Phi_qv exactly 0, the dense one rounding-level
    values."""
    P0, Cu0, cc0, rr = (t64(a) for a in _stage_inputs(5, 12, n, 6, seed=n))
    rr[:, :4] = 0.0
    dense = TZ.vanloan_dense(P0, Cu0, cc0, rr, 4, 6)
    struct = TZ.vanloan(P0, Cu0, cc0, rr, 4, 6)
    for o, r in zip(dense, struct):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r.numpy(), rtol=1e-10,
                                   atol=1e-13)
    assert (struct[2][:, :4] == 0).all()
    assert dense[2][:, :4].abs().max() <= 1e-12
    # and against the JAX package's dense route
    ref = jax.vmap(JZ._vanloan_cached(4, 6, "highest"))(
        *[jnp.asarray(a.numpy()) for a in (P0, Cu0, cc0, rr)])
    for o, r in zip(dense, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-11,
                                   atol=1e-13)


def test_dense_route_on_long_stages_fp64():
    """The (10, 20) grid's long stages (dt = 0.2 s, and up to 0.29 s at the
    correction step) at order 6 / 4 squarings against scipy-grade expm
    (order 18, 10 squarings) on lateral-model Jacobians: the truncation
    error of the chain the kernel runs, 1e-6 relative."""
    rng = np.random.default_rng(7)
    K = 30
    q = np.stack([rng.uniform(-0.3, 0.3, K), rng.uniform(-0.3, 0.3, K),
                  rng.uniform(-0.1, 0.1, K), rng.uniform(-0.5, 0.5, K)], 1)
    ur = np.stack([rng.uniform(-0.1, 0.1, K), rng.uniform(-2e3, 2e3, K),
                   rng.uniform(5, 12, K), rng.uniform(-0.03, 0.03, K),
                   np.zeros(K), np.zeros(K)], 1)
    dts = np.concatenate([np.full(10, 0.01), [0.29], np.full(19, 0.2)])

    def tf(q_, r_):
        return TD.vehicle_ode(VEH, "lateral", q_, r_[..., :2], r_[..., 2:])

    Jq, Ju = TZ.batched_jacobians(tf, t64(q), t64(ur))
    d3 = t64(dts)[:, None, None]
    args = (Jq * d3, Ju * d3, (tf(t64(q), t64(ur)) * t64(dts)[:, None])
            [..., None], t64(dts))
    lo = TZ.vanloan_dense(*args, 4, 6)
    hi = TZ.vanloan_dense(*args, 10, 18)
    for a, b in zip(lo, hi):
        assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_linearize_horizon_fused_dense_lateral_fp64():
    """The fused linearization of the lateral model through the dense
    route against the JAX package's unbatched call (which takes its dense
    `impl`)."""
    rng = np.random.default_rng(5)
    N, S = 13, 4
    qs = np.stack([rng.uniform(-0.3, 0.3, N), rng.uniform(-0.3, 0.3, N),
                   rng.uniform(-0.1, 0.1, N), rng.uniform(-0.5, 0.5, N)], 1)
    urs = np.stack([rng.uniform(-0.1, 0.1, N), rng.uniform(-2e3, 2e3, N),
                    rng.uniform(5, 9, N), rng.uniform(-0.03, 0.03, N),
                    np.zeros(N), np.zeros(N)], 1)
    dts = np.concatenate([np.full(S, 0.01), np.full(N - 1 - S, 0.2)])

    def jf(q, ur):
        return JD.vehicle_ode(VEH, "lateral", q, ur[:2], ur[2:])

    def tf(q, ur):
        return TD.vehicle_ode(VEH, "lateral", q, ur[..., :2], ur[..., 2:])

    ref = JZ.linearize_horizon_fused(
        jf, jnp.asarray(qs), jnp.asarray(urs), jnp.asarray(dts), S, 1,
        squarings=4, order=6, precision="high")
    out = TZ.linearize_horizon_fused(
        tf, t64(qs)[None], t64(urs)[None], t64(dts)[None], S, 1,
        squarings=4, order=6, dense=True)
    for o, r, name in zip(out, ref, ("A", "B0", "Bf", "c")):
        np.testing.assert_allclose(o[0].numpy(), np.asarray(r), rtol=1e-9,
                                   atol=1e-10, err_msg=name)


def test_expm_dense_rejects_bad_arguments():
    M = t64(np.zeros((3, 5, 5)))
    with pytest.raises(ValueError, match="d, d"):
        TZ.expm_dense(M[:, :4], 4, 6)
    with pytest.raises(ValueError, match="order"):
        TZ.expm_dense(M, 4, 0)
    with pytest.raises(ValueError, match="shape"):
        TZ.vanloan_dense(M, M, M[..., :1], M[:, 0], 4, 6)


@pytest.mark.parametrize("d", [1, 2, 7, 16, 17, 18, 19, 20, 32])
def test_expm_build_picks_exact_build_for_path_shapes(d):
    """The kernel's exact builds are the two stage-matrix sizes (19
    coupled, 17 decoupled); every other d takes the run-time build 0."""
    assert TZ.expm_build(d) == (d if d in (17, 19) else 0)


@pytest.mark.parametrize("d", [0, 33, -1])
def test_expm_build_rejects_d_outside_kernel(d):
    with pytest.raises(ValueError, match="d <="):
        TZ.expm_build(d)


@pytest.mark.parametrize("squarings,order", [(4, 0), (4, -1), (-1, 6)])
def test_expm_dense_rejects_order_and_squarings(squarings, order):
    M = t64(np.zeros((2, 19, 19)))
    with pytest.raises(ValueError, match="order >= 1 and squarings >= 0"):
        TZ.expm_dense(M, squarings, order)


@pytest.mark.parametrize("T,n", [(15, 6), (30, 4)],
                         ids=["coupled", "decoupled"])
def test_vanloan_dense_simulate_shapes_match_packed_chain_fp64(T, n):
    """`vanloan_dense` at `mpc.simulate`'s shapes (15 stages of the 19 x 19
    coupled stage matrix, 30 of the 17 x 17 decoupled one; order 6, 4
    squarings) against the JAX package's packed chain on the same dense
    stage matrices, at float64: rounding only."""
    m = 6
    P0, Cu0, cc0, rr = (t64(a[0]) for a in
                        _stage_inputs(1, T, n, m, seed=T + n))
    rr[: T // 3] = 0.0
    out = TZ.vanloan_dense(P0, Cu0, cc0, rr, 4, 6)
    dim = n + 2 * m + 1
    M = np.zeros((T, dim, dim))
    M[:, :n, :n] = P0.numpy()
    M[:, :n, n:n + m] = Cu0.numpy()
    M[:, :n, -1] = cc0.numpy()[..., 0]
    M[:, n:n + m, n + m:n + 2 * m] = rr.numpy()[:, None, None] * np.eye(m)
    E = np.asarray(JZ._expm_stage_packed_impl(jnp.asarray(M), 4, 6,
                                              "highest"))
    ref = (E[:, :n, :n], E[:, :n, n:n + m], E[:, :n, n + m:n + 2 * m],
           E[:, :n, -1:])
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=1e-12, atol=1e-13)
