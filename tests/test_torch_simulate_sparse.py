"""The sparse coupled formulation on the port's single-vehicle route:
`mpc.simulate` (and so `mpc.mpc_step`) against the JAX package's
`simulate` for 5 closed-loop steps at float64, horizon (2, 3), backend
"xla" with the "chol" and the "banded" factor (whose stage recursion is
the plain PyTorch scan on this route, as the JAX package's is its XLA
scan)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, t64, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO

OPTS = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
            backend="xla", scaling_iters=4)


@pytest.mark.parametrize("factor", ["chol", "banded"])
def test_simulate_matches_jax(factor):
    opts = dict(OPTS, factor_method=factor)
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=2, N_long=3),
                                solver=JSO(**opts))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=2, N_long=3),
                                solver=TSO(**opts))
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    jcache = JH.inactive_cache()
    q0 = np.array([0.3, 0.4, 0.02, 5.0, 0.05, 0.0])
    jlog = jax.jit(lambda q: JM.simulate(jcfg, jtube, jcache, q,
                                         n_steps=5))(jnp.asarray(q0))
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=torch.float64)
    tcache = convert.cache_from_numpy(cache_arrays(jcache), device="cpu")
    _kernels.reset_launches()
    tlog = TM.simulate(tcfg, ttube, tcache, t64(q0), n_steps=5, device="cpu")
    # CPU tensors take the plain versions: nothing is launched
    assert not any(_kernels.launches().values())
    assert tlog.q.shape == (5, 6) and tlog.u.dtype == torch.float64
    d = np.abs(tlog.u.numpy() - np.asarray(jlog.u))
    assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, d
    np.testing.assert_allclose(tlog.q.numpy(), np.asarray(jlog.q),
                               atol=1e-6)
    np.testing.assert_array_equal(tlog.diag.converged.numpy(),
                                  np.asarray(jlog.diag.converged))
    assert tlog.diag.converged.all()
    np.testing.assert_array_equal(tlog.diag.iterations.numpy(),
                                  np.asarray(jlog.diag.iterations))
