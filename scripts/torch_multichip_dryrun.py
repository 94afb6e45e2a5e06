"""Multi-card dry run of the port: one sharded control step of each of
two configurations and a grid-sharded HJI solve, on a mesh of every rank.

1. The flagship (the soft coupled QP on the lane solver, bench.py's
   options) through `parallel.shard.make_sharded_step` over "dp", the
   fleet metrics all-reduced.
2. The sparse coupled QP with the banded factor; when the world is even
   and at least 4, its identity columns split over tp = 2 and
   re-assembled by all_gather (`factor_inv_banded(tp_axis="tp")`).
3. `hji_solve.solve_hji(mesh=)` on a small 7-D grid (2 world rows on the
   first axis, 6 sweeps) with halo rows exchanged between neighbours.

The port's counterpart of the JAX package's `dryrun_multichip`
(__graft_entry__.py).  Run one process a card:

    torchrun --nproc_per_node=N scripts/torch_multichip_dryrun.py

or N CPU processes over gloo:

    python scripts/torch_multichip_dryrun.py --gloo --nproc N

Rank 0 prints one summary line; every rank raises on a non-finite
output.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))


def _fleet(cfg, B: int, device):
    """B copies of one vehicle on a straight 60 m path at 5 m/s (the JAX
    dry run's set-up), float32: (tube, cache, (carry, q0, u0, oc, t))."""
    from pigeon_tpu_torch import hji, mpc, trajectory

    f32 = dict(dtype=torch.float32, device=device)
    tube = trajectory.straight_trajectory(60.0, 5.0, pad_to=32, **f32)
    q0 = torch.tensor([0.3, 0.0, 0.02, 5.0, 0.0, 0.0], **f32).repeat(B, 1)
    oc = torch.tensor([1e4, 1e4, 0.0, 0.0], **f32).repeat(B, 1)
    args = (mpc.init_carry(cfg, B, device=device), q0,
            torch.zeros((B, 3), **f32), oc, torch.zeros(B, **f32))
    return tube, hji.inactive_cache(device=device), args


def dryrun(device_type: str) -> dict:
    """The three runs on the initialised world, every rank with the same
    arguments; returns the summary (the same on every rank)."""
    import torch.distributed as dist

    from pigeon_tpu_torch import hji_solve, mpc
    from pigeon_tpu_torch.config import SolverOptions, x1_params
    from pigeon_tpu_torch.parallel import mesh as pm
    from pigeon_tpu_torch.parallel import shard

    world = dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device())
              if device_type == "cuda" else torch.device("cpu"))
    tp = 2 if world % 2 == 0 and world >= 4 else 1
    dp = world // tp
    mesh = shard.make_mesh_2d(tp=tp, devices=device_type)
    B = 2 * dp

    def run(cfg):
        tube, cache, args = _fleet(cfg, B, device)
        step = shard.make_sharded_step(cfg, tube, cache, mesh)
        _, u3, _, metrics = step(*shard.shard_batch_dp(args, mesh))
        u3 = pm.gather_batch(u3, mesh)
        if tuple(u3.shape) != (B, 3) or not bool(torch.isfinite(u3).all()):
            raise RuntimeError(f"multi-card dry run: commands {u3}")
        return metrics

    flagship = run(dataclasses.replace(
        mpc.x1_coupled_config(soft=True), solver=SolverOptions(
            max_iter=150, check_every=150, eps_abs=1e-3, eps_rel=1e-3,
            backend="lanes", scaling_iters=2, pallas_check_inner=10)))
    cfg = mpc.x1_coupled_config()
    sparse = run(dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, factor_method="banded")))

    mesh1d = pm.make_mesh(device_type=device_type)
    cache, deltas, _ = hji_solve.solve_hji(
        x1_params(), shape=(2 * world, 5, 5, 3, 3, 3, 3), n_sweeps=6,
        fx_samples=3, horizon_s=3.0, mesh=mesh1d, device=device)
    if not bool(torch.isfinite(cache.V).all()):
        raise RuntimeError("sharded HJI solve produced non-finite values")
    count = lambda m: f"{float(m.n_converged):.0f}/{float(m.n_scenarios):.0f}"
    return dict(world=world, dp=dp, tp=tp, batch=B, device=device_type,
                flagship_converged=count(flagship),
                flagship_all_finite=float(flagship.all_finite),
                sparse_converged=count(sparse),
                sparse_all_finite=float(sparse.all_finite),
                sparse_tp_factor=tp > 1,
                hji_sweeps=len(deltas), hji_points=cache.V.numel())


def _rank_main(device_type: str, init_method: "str | None" = None,
               rank: "int | None" = None, world: "int | None" = None):
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    kw = {} if init_method is None else dict(
        init_method=init_method, rank=rank, world_size=world)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            **kw)
    try:
        torch.set_num_threads(1)
        summary = dryrun(device_type)
        if dist.get_rank() == 0:
            print("torch_multichip_dryrun OK " + json.dumps(summary),
                  flush=True)
    finally:
        dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gloo", action="store_true",
                    help="spawn --nproc CPU processes over gloo")
    ap.add_argument("--nproc", type=int, default=4)
    args = ap.parse_args()
    if not args.gloo:
        # one process a card, the world from torchrun's environment
        _rank_main("cuda")
        return
    import multiprocessing
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        init = f"tcp://localhost:{sock.getsockname()[1]}"
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=("cpu", init, r,
                                                  args.nproc))
             for r in range(args.nproc)]
    for p in procs:
        p.start()
    for p in procs:
        p.join()
    if any(p.exitcode != 0 for p in procs):
        sys.exit(f"a rank failed: exit codes {[p.exitcode for p in procs]}")


if __name__ == "__main__":
    main()
