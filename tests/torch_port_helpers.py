"""Shared set-up of the tests that hold `pigeon_tpu_torch` against
`pigeon_tpu`: numpy views of JAX objects and the oval fleet."""

import numpy as np
import torch

from pigeon_tpu_torch import trajectory as TT

torch.set_num_threads(2)


def tube_arrays(jtube) -> dict:
    """A JAX TrajectoryTube as the numpy mapping `convert.tube_from_numpy`
    takes."""
    out = {k: np.asarray(getattr(jtube, k)) for k in TT.COLUMNS}
    out["n_valid"] = np.asarray(jtube.n_valid)
    for name in ("t_idx", "s_idx"):
        idx = getattr(jtube, name)
        out[name] = dict(table=np.asarray(idx.table), lo=np.asarray(idx.lo),
                         h=np.asarray(idx.h), fixups=idx.fixups)
    return out


def cache_arrays(jcache) -> dict:
    return dict(knots=[np.asarray(k) for k in jcache.knots],
                V=np.asarray(jcache.V),
                gradV=None if jcache.gradV is None
                else np.asarray(jcache.gradV),
                dims=jcache.dims, strides=jcache.strides)


def carry_arrays(jcarry) -> dict:
    return {k: np.asarray(v) for k, v in jcarry._asdict().items()}


def oval_fleet(B: int, seed: int = 0, k_max: int = 900):
    """bench.py's fleet placement on the in-repo oval: numpy (q0 (B, 6),
    t0 (B,)) and the oval's columns."""
    cols = TT.oval_columns()
    rng = np.random.default_rng(seed)
    k0 = rng.integers(0, k_max, B)
    E = cols["E"][k0] + rng.uniform(-0.5, 0.5, B)
    N = cols["N"][k0] + rng.uniform(-0.5, 0.5, B)
    psi = cols["psi"][k0] + rng.uniform(-0.05, 0.05, B)
    q0 = np.stack([E, N, psi, np.full(B, 6.0), np.zeros(B), np.zeros(B)],
                  axis=1)
    return q0, cols["t"][k0], cols


def straight_fleet(B: int = 3):
    """tests/test_soft.py's fleet for `trajectory.straight_trajectory`:
    numpy (q0 (B, 6), t0 (B,))."""
    q0 = np.stack([[0.2 * i, 0.3 * i, 0.01, 5.0, 0.05, 0.0]
                   for i in range(B)])
    return q0, np.zeros(B)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def random_admm_ops(B: int, sigma: float, seed=0, n=70, m=104,
                    dense_P=False, m_eq=0):
    """tests/test_pallas_admm.py's well-conditioned random QPs, batched,
    with their scalings (D, E, c = 1, P and q unscaled), as float32 numpy
    operands of a dense ADMM segment: mats (K^-1, A, q, l, u, rho), warm
    (x, z, y) and scalings.  The boxes are centred on A x0 for a random
    x0, so each QP is feasible and the early exit has something to find.
    `dense_P`: P a dense SPD (n, n) matrix, M M' / n plus the diagonal.
    `m_eq`: the first m_eq rows are equality rows (l = u) with ten times
    their drawn rho, as the mixed precision modes take them."""
    rng = np.random.default_rng(seed)
    cols = {k: [] for k in ("K", "A", "q", "l", "u", "rho", "P")}
    for _ in range(B):
        P = rng.uniform(0.1, 2.0, n)
        A = rng.standard_normal((m, n)) / np.sqrt(n)
        c_ = A @ rng.standard_normal(n)
        w = rng.uniform(0.1, 1.0, m)
        rho = rng.uniform(0.05, 5.0, m)
        if dense_P:
            M = rng.standard_normal((n, n // 2))
            P = np.diag(P) + M @ M.T / n
        w[:m_eq] = 0.0
        rho[:m_eq] *= 10.0
        K = (P if dense_P else np.diag(P)) + sigma * np.eye(n) \
            + (A.T * rho) @ A
        Kinv = np.linalg.inv(K)
        for k, v in (("K", 0.5 * (Kinv + Kinv.T)), ("A", A),
                     ("q", rng.standard_normal(n)), ("l", c_ - w),
                     ("u", c_ + w), ("rho", rho), ("P", P)):
            cols[k].append(v)
    f = lambda k: np.asarray(cols[k], np.float32)
    warm = [np.asarray(0.1 * rng.standard_normal(s), np.float32)
            for s in ((B, n), (B, m), (B, m))]
    ones = lambda *s: np.ones(s, np.float32)
    return dict(mats=[f(k) for k in ("K", "A", "q", "l", "u", "rho")],
                warm=warm,
                scalings=[ones(B, n), ones(B, m), ones(B), f("P"), f("q")])


def hji_sharded_worker(rank: int, world: int, store: str, out: str,
                       case: str, kw: dict):
    """One rank of a gloo group over a FileStore: the sharded HJI solver
    on a 1-D CPU device mesh named "dp", its result saved to
    `out`_<rank>.npz.  case "smooth": `solve_hji_vi_sharded` on the
    pursuit game (`hji_solve.pursuit_target` on a (40, 41) grid, speed
    1); "vehicle": `solve_hji(mesh=)`
    at float64 with `kw`."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from pigeon_tpu_torch import hji_solve
    from pigeon_tpu_torch.config import x1_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("dp",))
        if case == "smooth":
            l, hs = hji_solve.pursuit_target((40, 41))
            V, d, t = hji_solve.solve_hji_vi_sharded(
                torch.as_tensor(l), hs, hji_solve.pursuit_flow(1.0),
                mesh=mesh, **kw)
            V = V.numpy()
        else:
            cache, d, t = hji_solve.solve_hji(
                x1_params(), mesh=mesh, dtype=torch.float64, device="cpu",
                **kw)
            V = cache.V.numpy()
        np.savez(f"{out}_{rank}.npz", V=V, deltas=np.asarray(d),
                 times=np.asarray(t))
    finally:
        dist.destroy_process_group()


def start_world(tmp_path, world: int, target, runs: dict,
                join_s: float = 150.0):
    """Start `target(rank, world, store, out, runs)` on `world` spawned
    CPU processes meeting through a FileStore in `tmp_path` (no port to
    race for between test workers).  `runs` maps a tag to (case, kw), run
    in turn in the one world.  Returns `collect()`, which joins them (a
    join timeout turns a hang into a failure) and returns each tag's list
    of the ranks' saved arrays; the caller may work meanwhile."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out = str(tmp_path / "world")
    procs = [ctx.Process(target=target,
                         args=(r, world, str(tmp_path / "store"), out, runs))
             for r in range(world)]
    for p in procs:
        p.start()

    def collect():
        try:
            for p in procs:
                p.join(join_s)
            assert not any(p.is_alive() for p in procs), "a rank hung"
            assert all(p.exitcode == 0 for p in procs), \
                [p.exitcode for p in procs]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
        return {tag: [dict(np.load(f"{out}_{tag}_{r}.npz",
                                   allow_pickle=False))
                      for r in range(world)] for tag in runs}
    return collect


def spawn_world(tmp_path, world: int, target, runs: dict) -> dict:
    """`start_world` and its `collect()`."""
    return start_world(tmp_path, world, target, runs)()


# tests/test_shard.py's set-up: the sparse QP on the plain solver with
# the banded factor, a straight path, eight vehicles 2 m apart
SHARD_SOLVER = dict(max_iter=100, check_every=50, backend="xla",
                    factor_method="banded", scaling_iters=4)
SHARD_B = 8


def shard_setup(B: int = SHARD_B):
    """The port's (cfg, tube, cache, (carry, q0, u0, other cars, t)) of
    tests/test_shard.py's `_setup` at float64."""
    import dataclasses

    from pigeon_tpu_torch import hji, mpc
    from pigeon_tpu_torch.config import SolverOptions

    cfg = dataclasses.replace(mpc.x1_coupled_config(),
                              solver=SolverOptions(**SHARD_SOLVER))
    tube = TT.straight_trajectory(80.0, 6.0, pad_to=32, device="cpu",
                                  dtype=torch.float64)
    q0 = t64([[0.3, 2.0 * i, 0.0, 6.0, 0.0, 0.0] for i in range(B)])
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    args = (mpc.init_carry(cfg, B, dtype=torch.float64, device="cpu"), q0,
            torch.zeros((B, 3), dtype=torch.float64), oc,
            torch.zeros(B, dtype=torch.float64))
    return cfg, tube, hji.inactive_cache(device="cpu"), args


def shard_closed_loop(step, args, n_steps: int = 3):
    """tests/test_shard.py's closed loop: the commands fed back, the
    states held, the time advanced by 10 ms a step.  Returns the last
    (carry, u3, diag, metrics-or-None)."""
    cb, q0, u0, oc, ts = args
    for i in range(n_steps):
        out = step(cb, q0, u0, oc, ts + 0.01 * i)
        cb, u0 = out[0], out[1]
    return out


def scaled_sparse_qp(hz, B: int = 4):
    """Ruiz-scaled P, A and a two-level per-row rho of one cold step's
    sparse QPs on the oval at float64 (tests/test_torch_banded.py's
    set-up), with the stage plan: (Pb, Ab, rho, plan)."""
    from pigeon_tpu_torch import hji, mpc
    from pigeon_tpu_torch.config import HorizonParams
    from pigeon_tpu_torch.solver import admm, banded

    cfg = mpc.x1_coupled_config(hz=HorizonParams(N_short=hz[0],
                                                 N_long=hz[1]))
    q0, t0, cols = oval_fleet(B, seed=12)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = mpc.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = mpc._pre_solve(cfg, tube, hji.inactive_cache(device="cpu"),
                              carry, t64(q0), t64(np.zeros((B, 3))), oc,
                              t64(t0))
    (Pb, _, Ab, _, _), _, _, _ = admm.ruiz(qp, 4)
    rho = torch.where((qp.u - qp.l) < 1e-10, 100.0, 0.1).to(torch.float64)
    rho = rho * torch.linspace(0.2, 50.0, B, dtype=torch.float64)[:, None]
    return Pb, Ab, rho, banded.coupled_stage_plan(cfg.hz)


# tests/test_torch_montecarlo.py's scenarios and solver, without the lane
# kernel's in-kernel exit groups (pallas_check_inner 0): a group is 128
# instances of the local batch, so a shard of a few scenarios would group
# them otherwise than the whole batch does
MESH_SOLVER = dict(max_iter=600, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
                   backend="lanes", scaling_iters=2, pallas_check_inner=0)
MESH_SCENARIOS = dict(seed=0, oncoming_gap=(6.0, 24.0),
                      oncoming_lateral=(-1.0, 1.0))


def mesh_setup(B: int):
    """The port's Monte-Carlo set-up of tests/test_torch_mesh.py at
    float64: (cfg, tube, cache, scenarios) on the oval with the
    synthetic cache, the override on at eps 1.5."""
    import dataclasses

    from pigeon_tpu_torch import hji, montecarlo, mpc
    from pigeon_tpu_torch.config import SolverOptions

    cfg = dataclasses.replace(mpc.x1_coupled_config(soft=True),
                              solver=SolverOptions(**MESH_SOLVER),
                              use_hji_policy=True, hji_eps=1.5)
    tube = TT.make_tube(**TT.oval_columns(), pad_to=1024, device="cpu",
                        dtype=torch.float64)
    cache = hji.synthetic_cache(5, device="cpu")
    scen = montecarlo.sample_scenarios(tube, B, dtype=torch.float64,
                                       **MESH_SCENARIOS)
    return cfg, tube, cache, scen


def mesh_worker(rank: int, world: int, store: str, out: str, runs: dict):
    """One rank of a gloo world over a FileStore running the port's mesh
    paths, each run of `runs` (tag: (case, kw)) saved to
    `out`_<tag>_<rank>.npz.  case "shard": `make_sharded_step` on
    a (world / tp, tp) mesh, one step and a 3-step closed loop, outputs
    gathered over dp; "factor": `factor_inv_banded(tp_axis="tp")` on a (1,
    world) mesh for each horizon of kw["hz"], beside the factor without
    tp (or the ValueError's text); "mesh": `BatchedController(mesh=)`
    rollout and `run_dynamic_obstacle(mesh=)` on kw["B"] scenarios,
    kw["steps"] steps, logs gathered; "dryrun":
    scripts/torch_multichip_dryrun.py's `dryrun` on the CPU."""
    import json

    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for tag, (case, kw) in runs.items():
            save = _MESH_CASES[case](world, kw)
            np.savez(f"{out}_{tag}_{rank}.npz",
                     **{k: (np.asarray(json.dumps(v)) if isinstance(v, dict)
                            else np.asarray(v)) for k, v in save.items()})
    finally:
        dist.destroy_process_group()


def _case_shard(world, kw):
    from pigeon_tpu_torch.parallel import mesh as pm
    from pigeon_tpu_torch.parallel import shard

    mesh = shard.make_mesh_2d(tp=kw["tp"], devices="cpu")
    cfg, tube, cache, args = shard_setup()
    step = shard.make_sharded_step(cfg, tube, cache, mesh)
    local = shard.shard_batch_dp(args, mesh)
    c2, u3, diag, metrics = step(*local)
    cl = shard_closed_loop(step, local)
    g = lambda x: pm.gather_batch(x, mesh).numpy()
    return dict(u3=g(u3), e=g(diag.e), converged=g(diag.converged),
                iterations=g(diag.iterations), solved=g(c2.solved),
                warm_x=g(c2.warm_x),
                metrics=np.asarray([float(v) for v in metrics]),
                loop_u3=g(cl[1]),
                loop_metrics=np.asarray([float(v) for v in cl[3]]))


def _case_factor(world, kw):
    from pigeon_tpu_torch.parallel import shard
    from pigeon_tpu_torch.solver import banded

    mesh = shard.make_mesh_2d(tp=world, devices="cpu")
    save = {}
    for hz in kw["hz"]:
        Pb, Ab, rho, (slots, n, bw, nb) = scaled_sparse_qp(hz)
        name = f"{hz[0]}_{hz[1]}"
        save[f"plain_{name}"] = banded.factor_inv_banded(
            Pb, Ab, rho, 1e-6, slots, n, bw, nb).numpy()
        try:
            with shard.axis_env(mesh):
                save[f"tp_{name}"] = banded.factor_inv_banded(
                    Pb, Ab, rho, 1e-6, slots, n, bw, nb,
                    tp_axis="tp").numpy()
        except ValueError as err:
            save[f"error_{name}"] = str(err)
    return save


def _case_mesh(world, kw):
    from pigeon_tpu_torch import montecarlo
    from pigeon_tpu_torch.parallel import mesh as pm

    mesh = pm.make_mesh(device_type="cpu")
    cfg, tube, cache, scen = mesh_setup(kw["B"])
    ctrl = pm.BatchedController(cfg, tube, cache, mesh=mesh)
    state = ctrl.init_state(scen.q0)
    state, (q, u, oc, diag) = ctrl.rollout(state, kw["steps"],
                                           other_car=scen.other0, t0=scen.t0)
    logs = pm.gather_batch((q, u, oc, diag.converged, diag.hji_active,
                            diag.iterations), mesh, dim=1)
    summary, per = montecarlo.run_dynamic_obstacle(
        cfg, tube, cache, scen, n_steps=kw["steps"], mesh=mesh,
        per_scenario=True)
    return dict(zip(("q", "u", "oc", "converged", "hji_active",
                     "iterations"), (x.numpy() for x in logs)),
                final_q=pm.gather_batch(state.q, mesh).numpy(),
                summary=summary._asdict(),
                per_min_sep=per.min_separation_m.numpy(),
                local_rows=np.asarray(state.q.shape[0]))


def _case_dryrun(world, kw):
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                        "torch_multichip_dryrun.py")
    spec = importlib.util.spec_from_file_location("torch_multichip_dryrun",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return dict(summary=mod.dryrun("cpu"))


_MESH_CASES = {"shard": _case_shard, "factor": _case_factor,
               "mesh": _case_mesh, "dryrun": _case_dryrun}
