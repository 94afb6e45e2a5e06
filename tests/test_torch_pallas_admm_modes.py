"""The dense ADMM kernel's precision modes ("mixed", "mixedk6", "high",
"bf16") in the port's plain version (what `csrc/admm_dense.cu` computes)
against the JAX package's kernel in interpret mode at float32: 5 instances
in tiles of 2 of tests/test_pallas_admm.py's well-conditioned random QPs
(n=70, m=104), the first 24 rows equality rows, with a diagonal or a dense
P, over a fixed segment and with the early exit per tile.

A run-time vector's bf16 split (or rounding) is discontinuous in it: the
port and the JAX kernel sum in different orders, so where a vector entry
lies within float32 rounding of a bf16 boundary the two take different
halves, and the split products differ by ~2^-16 of their scale ("bf16":
2^-8).  Iterated, that is each mode's own rounding noise, so each case
holds the port to the float64 plain version of the same mode (bf16
roundings kept, sums in float64): no further from it than three times the
JAX kernel is (the bar of the pipeline tests), executed counts within one
check of the JAX kernel's.  And each case shows the mode is the JAX
mode: after one iteration from the warm start, where the inputs of the
first products are equal, the port's x lies at most half as far from the
JAX kernel's same mode as from its "highest"."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import random_admm_ops
from pigeon_tpu.solver.pallas_admm import admm_iterations as j_admm
from pigeon_tpu_torch.solver import pallas_admm as TP

B, TILE, CHECK, M_EQ = 5, 2, 10, 24
SIGMA, ALPHA = 1e-6, 1.6
MODES = ("mixed", "mixedk6", "high", "bf16")
RUNS = {"fixed": (30, 0), "early_exit": (200, CHECK)}


def _mode_kw(mode):
    return dict(bf16=True) if mode == "bf16" else dict(precision=mode)


@functools.lru_cache(maxsize=None)
def _ops(dense_P):
    return random_admm_ops(B, SIGMA, seed=3 if dense_P else 0,
                           dense_P=dense_P, m_eq=M_EQ)


@functools.lru_cache(maxsize=None)
def _jax(mode, dense_P, n_iters, check):
    ops = _ops(dense_P)
    out = j_admm(*[jnp.asarray(a) for a in ops["mats"] + ops["warm"]],
                 n_iters, SIGMA, ALPHA, tile=TILE, interpret=True,
                 scalings=tuple(jnp.asarray(a) for a in ops["scalings"]),
                 check=check, m_eq=M_EQ, dense_P=dense_P, **_mode_kw(mode))
    return [np.asarray(o, np.float64) for o in out]


def _port(mode, dense_P, n_iters, check, dtype=torch.float32):
    ops = _ops(dense_P)
    T = lambda a: torch.as_tensor(a).to(dtype)
    out = TP.admm_iterations(
        *[T(a) for a in ops["mats"] + ops["warm"]], n_iters, SIGMA, ALPHA,
        tile=TILE, scalings=tuple(T(a) for a in ops["scalings"]),
        check=check, m_eq=M_EQ, dense_P=dense_P, **_mode_kw(mode))
    assert all(o.dtype == dtype for o in out)
    return [o.double().numpy() for o in out]


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("dense_P", [False, True], ids=["diag_P", "dense_P"])
@pytest.mark.parametrize("mode", MODES)
def test_mode_matches_jax_kernel(mode, dense_P, run):
    n_iters, check = RUNS[run]
    port = _port(mode, dense_P, n_iters, check)
    jax_ = _jax(mode, dense_P, n_iters, check)
    exact = _port(mode, dense_P, n_iters, check, torch.float64)
    for name, p, j, e in zip(("x", "z", "y"), port, jax_, exact):
        assert p.shape == j.shape and np.isfinite(p).all(), name
        d_port, d_jax = np.abs(p - e).max(), np.abs(j - e).max()
        assert d_port <= 3.0 * d_jax + 1e-6 * np.abs(e).max(), (
            name, d_port, d_jax)
    # the statistics the early exit reads, each a maximum over rows or
    # columns, by the same bar over each group: the magnitudes (columns
    # 2-5) plus 1e-6 of their scale, the residuals (0, 1) plus 2e-4 of the
    # magnitudes they are differences of (tests/test_torch_pallas_admm.py)
    sp, sj, se = port[3][:, :6], jax_[3][:, :6], exact[3][:, :6]
    scale = np.abs(se[:, 2:]).max()
    for cols, slack in ((slice(2, 6), 1e-6), (slice(0, 2), 2e-4)):
        d_port = np.abs(sp[:, cols] - se[:, cols]).max()
        d_jax = np.abs(sj[:, cols] - se[:, cols]).max()
        assert d_port <= 3.0 * d_jax + slack * scale, (cols, d_port, d_jax)
    ex_p, ex_j = port[3][:, 6], jax_[3][:, 6]
    assert np.abs(ex_p - ex_j).max() <= CHECK, (ex_p, ex_j)
    for t0 in range(0, B, TILE):
        assert len(set(ex_p[t0:t0 + TILE])) == 1
    np.testing.assert_array_equal(port[3][:, 7], 0.0)
    if check == 0:
        assert (ex_p == n_iters).all()
    # the mode is the JAX kernel's: one iteration from the warm start
    x1 = _port(mode, dense_P, 1, 0)[0]
    d_same = np.linalg.norm(x1 - _jax(mode, dense_P, 1, 0)[0])
    d_highest = np.linalg.norm(x1 - _jax("highest", dense_P, 1, 0)[0])
    assert d_same <= 0.5 * d_highest, (d_same, d_highest)


@pytest.mark.parametrize("mode", ["mixed", "mixedk6"])
def test_mixed_mode_needs_equality_rows(mode):
    """As the JAX kernel: a mixed mode without 0 < m_eq <= m raises."""
    ops = _ops(False)
    args = [torch.as_tensor(a) for a in ops["mats"] + ops["warm"]]
    for m_eq in (0, 105):
        with pytest.raises(ValueError):
            TP.admm_iterations(*args, 10, SIGMA, ALPHA, tile=TILE,
                               precision=mode, m_eq=m_eq)


def test_unknown_precision_raises():
    ops = _ops(False)
    args = [torch.as_tensor(a) for a in ops["mats"] + ops["warm"]]
    with pytest.raises(ValueError):
        TP.admm_iterations(*args, 10, SIGMA, ALPHA, precision="low")
