"""The port's data-parallel closed loop (`parallel/mesh.py`:
`BatchedController(mesh=)`, `make_mesh`, `shard_batch`, `replicate`,
`gather_batch`) and `montecarlo.run_dynamic_obstacle(mesh=)` on 2 and 4
CPU processes over gloo, against the mesh-less port and the JAX package's
`BatchedController(mesh=make_mesh(8))` on its 8-device CPU mesh.

tests/test_torch_montecarlo.py's set-up (the oval, the synthetic cache,
the override on at eps 1.5, scripts/exp_safety_ab.py's 12 segments of 50
iterations on the lane solver, at float64 outside the float32 solver) on
8 scenarios, 4 or 2 a rank, with the lane kernel's in-kernel exit off:
its exit groups are 128 instances of the local batch, so a small shard
would group them otherwise than the whole batch does.  The controller
takes its segment decisions over all ranks (`admm.global_batch`), so
each scenario's result is the mesh-less one to the bit; each step is
held to the JAX package's mesh step from the same state at
tests/test_torch_montecarlo.py's bars."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_helpers import (MESH_SOLVER, mesh_setup, mesh_worker,
                                start_world)
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.parallel.mesh import BatchedController as JBC
from pigeon_tpu.parallel.mesh import BatchState as JBS
from pigeon_tpu.parallel.mesh import make_mesh as jax_make_mesh
from pigeon_tpu.parallel.mesh import shard_batch as jax_shard_batch
from pigeon_tpu_torch import montecarlo as TMC
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import x1_params as tx1
from pigeon_tpu_torch.parallel.mesh import BatchedController

B, STEPS = 8, 5
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2-rank world (started first, collected last); meanwhile the
    mesh-less port's rollout (each step's arguments recorded) and
    summary, and the JAX package's mesh controller stepped from each of
    the port's states."""
    collect = [start_world(tmp_path_factory.mktemp(f"mesh{w}"), w,
                           mesh_worker, {w: ("mesh", dict(B=B, steps=STEPS))})
               for w in WORLDS]
    cfg, tube, cache, scen = mesh_setup(B)
    steps = []

    class Recording(BatchedController):
        def step(self, state, other_car=None, t=0.0):
            out = super().step(state, other_car, t)
            steps.append(((state, other_car, t), out))
            return out

    ctrl = Recording(cfg, tube, cache)
    state, logs = ctrl.rollout(ctrl.init_state(scen.q0), STEPS,
                               other_car=scen.other0, t0=scen.t0)
    summary, per = TMC.run_dynamic_obstacle(cfg, tube, cache, scen,
                                            n_steps=STEPS, per_scenario=True)

    jtube = JT.make_tube(**TT.oval_columns(), pad_to=1024)
    jcfg = dataclasses.replace(JM.x1_coupled_config(soft=True),
                               solver=JSO(**MESH_SOLVER),
                               use_hji_policy=True, hji_eps=1.5)
    mesh = jax_make_mesh(8)
    jctrl = JBC(jcfg, jtube, JH.synthetic_cache(5), mesh=mesh)
    J = lambda v: jnp.asarray(v.numpy())
    forced = []
    for (st, oc, t), _ in steps[:STEPS]:
        jst = jax_shard_batch(JBS(carry=JM.MPCCarry(*[J(x) for x in st.carry]),
                                  q=J(st.q), u=J(st.u)), mesh)
        forced.append(jctrl.step(jst, jax_shard_batch(J(oc), mesh),
                                 jax_shard_batch(J(t), mesh)))
    out = dict(port=(state, logs, summary, per),
               port_steps=[o for _, o in steps[:STEPS]], jax_steps=forced)
    for c in collect:
        out.update(c())
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_rollout_matches_meshless(runs, world):
    """Every rank's gathered logs equal the mesh-less rollout's to the
    bit; each rank holds its B / world rows."""
    state, (q, u, oc, diag), _, _ = runs["port"]
    for out in runs[world]:
        assert int(out["local_rows"]) == B // world
        for name, ref in (("q", q), ("u", u), ("oc", oc),
                          ("converged", diag.converged),
                          ("hji_active", diag.hji_active),
                          ("iterations", diag.iterations)):
            np.testing.assert_array_equal(out[name], ref.numpy(), name)
        np.testing.assert_array_equal(out["final_q"], state.q.numpy())


def test_mesh_rollout_matches_jax(runs):
    """Each step of the rollout (the mesh's, equal to the mesh-less one
    above) against the JAX package's mesh controller stepped from the
    same state on its 8-device mesh, at tests/test_torch_montecarlo.py's
    bars: commands within 2e-4 rad and 2 N, the same filter, convergence
    and warm-start flags, iterations within one segment, the plants'
    next states within 1e-12, the override's steering at its limit.
    (Free-running, the two packages' rollouts part by tens of newtons:
    a weakly determined force moves with rounding-level changes of the
    state, in either package.)"""
    assert len(runs["port_steps"]) == STEPS
    for k, ((tst, td), (jst, jd)) in enumerate(zip(runs["port_steps"],
                                                   runs["jax_steps"])):
        d = np.abs(tst.u.numpy() - np.asarray(jst.u))
        assert d[:, 0].max() < 2e-4 and d[:, 1:].max() < 2.0, (k, d)
        for name in ("hji_active", "converged"):
            np.testing.assert_array_equal(getattr(td, name).numpy(),
                                          np.asarray(getattr(jd, name)))
        assert np.abs(td.iterations.numpy()
                      - np.asarray(jd.iterations)).max() <= 50, k
        np.testing.assert_array_equal(tst.carry.solved.numpy(),
                                      np.asarray(jst.carry.solved))
        np.testing.assert_allclose(tst.q.numpy(), np.asarray(jst.q),
                                   rtol=0, atol=1e-12)
        active = td.hji_active.numpy()
        np.testing.assert_allclose(np.abs(tst.u.numpy()[active][:, 0]),
                                   tx1().delta_max, rtol=1e-12)
    active = runs[2][0]["hji_active"]
    assert active.any() and not active.all()


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_montecarlo_summary(runs, world):
    """run_dynamic_obstacle(mesh=): the whole fleet's summary on every
    rank, equal field for field to the mesh-less summary; PerScenario is
    the rank's shard."""
    _, _, summary, per = runs["port"]
    for rank, out in enumerate(runs[world]):
        got = json.loads(str(out["summary"]))
        assert got == summary._asdict()
        rows = slice(rank * B // world, (rank + 1) * B // world)
        np.testing.assert_array_equal(out["per_min_sep"],
                                      per.min_separation_m.numpy()[rows])

