"""The port's explicit-collective scale-out (`parallel/shard.py`:
`make_sharded_step`, `shard_batch_dp`, `FleetMetrics`, `make_mesh_2d`)
with the tensor-parallel banded factor, and
scripts/torch_multichip_dryrun.py, on 2 and 4 CPU processes over gloo,
against the port's unsharded step and the JAX package's, on
tests/test_shard.py's set-up at float64: the sparse QP, "xla", "banded",
100 iterations in segments of 50, eight vehicles on a straight path.

The plain ("xla") solve masks each instance on its own, so a shard's
instances come out as in the whole batch: the gathered commands and
errors are held to the unsharded step at JAX's own bars (rtol 1e-6,
atol 1e-8), to the JAX package's step at tests/test_torch_mpc_sparse.py's
(2e-4 rad, 2 N), and the fleet metrics to the JAX package's sharded
step on its 8-device CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import (SHARD_B, SHARD_SOLVER, mesh_worker,
                                shard_closed_loop, shard_setup, start_world)
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.parallel.shard import make_mesh_2d as jax_mesh_2d
from pigeon_tpu.parallel.shard import make_sharded_step as jax_sharded
from pigeon_tpu.parallel.shard import shard_batch_dp as jax_shard_dp
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.parallel import shard as TS

# (world, tp): dp = 2 and 4 with tp = 1, and dp = 2 with tp = 2
MESHES = [(2, 1), (4, 1), (4, 2)]


def _jax_setup(B=SHARD_B):
    """tests/test_shard.py's `_setup`."""
    cfg = dataclasses.replace(JM.x1_coupled_config(),
                              solver=JSO(**SHARD_SOLVER))
    tube = JT.straight_trajectory(80.0, 6.0, pad_to=32)
    carry = JM.init_carry(cfg, dtype=jnp.float64)
    cb = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), carry)
    q0 = jnp.asarray([[0.3, 2.0 * i, 0.0, 6.0, 0.0, 0.0]
                      for i in range(B)], jnp.float64)
    oc = jnp.broadcast_to(jnp.asarray([1e4, 1e4, 0.0, 0.0], jnp.float64),
                          (B, 4))
    return cfg, tube, JH.inactive_cache(), (
        cb, q0, jnp.zeros((B, 3), jnp.float64), oc,
        jnp.zeros(B, jnp.float64))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded step on every mesh of MESHES and the dry run on 4
    ranks (a world of 2 and one of 4 processes, started first and
    collected last); meanwhile the port's unsharded step and closed loop,
    the JAX package's unsharded step, and its sharded step's metrics and
    closed loop on the 8-device CPU mesh (tp = 1)."""
    collect = []
    for world in (2, 4):
        tags = {f"w{w}tp{tp}": ("shard", dict(tp=tp))
                for w, tp in MESHES if w == world}
        if world == 4:
            tags["dryrun"] = ("dryrun", {})
        collect.append(start_world(
            tmp_path_factory.mktemp(f"world{world}"), world, mesh_worker,
            tags))

    cfg, tube, cache, args = shard_setup()
    step = lambda *a: TM.mpc_step_batched(cfg, tube, cache, *a)
    out = dict(port=step(*args), port_loop=shard_closed_loop(step, args))

    jcfg, jtube, jcache, jargs = _jax_setup()
    out["jax"] = jax.jit(lambda *a: JM.mpc_step_batched(
        jcfg, jtube, jcache, *a))(*jargs)
    mesh = jax_mesh_2d(8, tp=1)
    sstep = jax.jit(jax_sharded(jcfg, jtube, jcache, mesh))
    sargs = jax_shard_dp(jargs, mesh)
    with mesh:
        jmetrics = sstep(*sargs)[3]
        cb, q0, u0, oc, ts = sargs
        for i in range(3):
            cb, u0, _, jloop = sstep(cb, q0, u0, oc, ts + 0.01 * i)
    as_np = lambda m: np.asarray([float(v) for v in m])
    out.update(jax_metrics=as_np(jmetrics), jax_loop=as_np(jloop),
               jax_loop_u3=np.asarray(u0))
    for c in collect:
        out.update(c())
    return out


@pytest.mark.parametrize("world,tp", MESHES, ids=[f"w{w}tp{t}"
                                                  for w, t in MESHES])
def test_sharded_step(runs, world, tp):
    """Every rank's gathered outputs against the unsharded step of both
    packages; the metrics the same on every rank and equal to the JAX
    package's sharded step's (n_converged exact, max_abs_e rel 1e-6); a
    3-step closed loop stays finite and converges as tests/test_shard.py
    asks, and matches the port's unsharded loop."""
    refs, outs = runs, runs[f"w{world}tp{tp}"]
    _, ref_u3, ref_diag = refs["port"]
    for out in outs[1:]:
        for k in ("u3", "e", "metrics", "loop_u3", "loop_metrics"):
            np.testing.assert_array_equal(out[k], outs[0][k])
    out = outs[0]
    np.testing.assert_allclose(out["u3"], ref_u3.numpy(), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(out["e"], ref_diag.e.numpy(), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_array_equal(out["converged"],
                                  ref_diag.converged.numpy())
    np.testing.assert_array_equal(out["solved"],
                                  refs["port"][0].solved.numpy())
    # the JAX package's unsharded step
    _, ju3, jdiag = refs["jax"]
    d = np.abs(out["u3"] - np.asarray(ju3))
    assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, d
    np.testing.assert_allclose(out["e"], np.asarray(jdiag.e), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(out["converged"],
                                  np.asarray(jdiag.converged))
    assert np.abs(out["iterations"]
                  - np.asarray(jdiag.iterations)).max() <= 10
    # the fleet metrics
    m, jm = out["metrics"], refs["jax_metrics"]
    names = TS.FleetMetrics._fields
    assert m[names.index("n_scenarios")] == SHARD_B == jm[0]
    for name in ("n_converged", "n_hji_active", "all_finite"):
        i = names.index(name)
        assert m[i] == jm[i], name
    for name in ("max_abs_e", "max_prim_res"):
        i = names.index(name)
        assert m[i] == pytest.approx(jm[i], rel=1e-6), name
    assert m[names.index("n_converged")] == float(
        ref_diag.converged.sum())
    # the closed loop
    lm = out["loop_metrics"]
    assert lm[names.index("all_finite")] == 1.0
    assert lm[names.index("n_converged")] >= 6.0
    assert lm[names.index("n_converged")] == refs["jax_loop"][1]
    np.testing.assert_allclose(out["loop_u3"], refs["port_loop"][1].numpy(),
                               rtol=1e-6, atol=1e-8)
    d = np.abs(out["loop_u3"] - refs["jax_loop_u3"])
    assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, d


def test_mesh_2d_needs_a_world():
    """Building a mesh without torch.distributed initialised raises a
    clear error."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        TS.make_mesh_2d(tp=1)


def test_multichip_dryrun_four_ranks(runs):
    """scripts/torch_multichip_dryrun.py on 4 ranks: dp = 2, tp = 2, the
    flagship and the sparse tp step finite and converged, the sharded
    HJI solve's 6 sweeps."""
    import json

    outs = runs["dryrun"]
    summaries = [json.loads(str(o["summary"])) for o in outs]
    assert all(s == summaries[0] for s in summaries)
    s = summaries[0]
    assert (s["world"], s["dp"], s["tp"], s["batch"]) == (4, 2, 2, 4)
    assert s["sparse_tp_factor"] and s["hji_sweeps"] == 6
    assert s["flagship_converged"] == s["sparse_converged"] == "4/4"
    assert s["flagship_all_finite"] == s["sparse_all_finite"] == 1.0
