"""Explicit-collective scale-out over a (dp, tp) device mesh.
Counterpart of `pigeon_tpu/parallel/shard.py`, in the SPMD idiom of
`parallel/mesh.py` (one process per card, a `DeviceMesh` with the
dimensions "dp" and "tp"):

- **dp** (scenario parallel): every rank runs the whole MPC step on its
  local shard of the batch (`shard_batch_dp`); the fleet metrics are
  reduced over the "dp" ranks with all_reduce, as the JAX package's body
  of `shard_map` does with psum / pmax / pmin.
- **tp** (tensor parallel over the KKT factor): the members of a "tp"
  group hold the same shard, and the banded factorization's identity
  right-hand-side columns are split over them
  (`solver/banded.factor_inv_banded(tp_axis="tp")`) and re-assembled with
  all_gather.  The step binds the mesh's dimension names to its process
  groups (`axis_env`) while it runs, as shard_map binds its axis names;
  outside that scope a named axis is unbound and the factor raises.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import NamedTuple

import torch

from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.parallel.mesh import (_require_initialized,
                                            default_device_type, replicate,
                                            shard_batch)

__all__ = ["FleetMetrics", "make_mesh_2d", "make_sharded_step",
           "shard_batch_dp", "replicate", "axis_env", "axis_group"]

# the axis names bound to process groups by the innermost `axis_env`
_AXES: contextvars.ContextVar = contextvars.ContextVar("axes", default={})


@contextlib.contextmanager
def axis_env(mesh):
    """Bind every dimension name of `mesh` to its process group for the
    code inside (shard_map's axis environment)."""
    token = _AXES.set(dict(_AXES.get(), **{
        name: mesh.get_group(name) for name in mesh.mesh_dim_names}))
    try:
        yield
    finally:
        _AXES.reset(token)


def axis_group(name: str):
    """The process group bound to a mesh axis name by `axis_env`; a
    NameError outside one, as JAX raises for an unbound axis name."""
    group = _AXES.get().get(name)
    if group is None:
        raise NameError(f"unbound axis name: {name} (a named axis runs "
                        f"inside make_sharded_step's step, which binds the "
                        f"mesh's dimensions)")
    return group


class FleetMetrics(NamedTuple):
    """Mesh-reduced per-step fleet statistics (sums and maxima over dp),
    float32 0-d tensors, identical on every rank."""

    n_scenarios: torch.Tensor     # total fleet size
    n_converged: torch.Tensor     # solver-converged count
    n_hji_active: torch.Tensor    # HJI-filter-active count
    max_abs_e: torch.Tensor       # worst tracking error in the fleet
    max_prim_res: torch.Tensor    # worst primal residual
    all_finite: torch.Tensor      # every command finite (1.0 or 0.0)


def make_mesh_2d(n_devices: "int | None" = None, tp: int = 1,
                 devices=None):
    """(dp, tp) mesh over the world's ranks, tp consecutive ranks a "tp"
    group; tp must divide the rank count (ValueError).  `n_devices`, if
    given, must be the world size (one rank a card); `devices` is the
    device type ("cuda" or "cpu"; None: the card where one is visible)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _require_initialized()
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the "
                         f"world's {n} ranks, one a card")
    if n % tp != 0:
        raise ValueError(f"tp={tp} does not divide {n} devices")
    return init_device_mesh(devices or default_device_type(), (n // tp, tp),
                            mesh_dim_names=("dp", "tp"))


def _fleet_metrics(diag: mpc_mod.StepDiagnostics, u3, ts, group):
    """The step's statistics reduced over `group`, each in float32 as the
    JAX package casts them: one SUM for the counts, one MAX for the maxima
    and the finite flag (its MIN as the MAX of its negation)."""
    import torch.distributed as dist

    f32 = lambda v: v.to(torch.float32)
    sums = torch.stack([f32(torch.ones_like(ts)).sum(),
                        f32(diag.converged).sum(),
                        f32(diag.hji_active).sum()])
    maxes = torch.stack([f32(diag.e.abs()).amax(),
                         f32(diag.prim_res).amax(),
                         -f32(torch.isfinite(u3).all())])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=group)
    return FleetMetrics(n_scenarios=sums[0], n_converged=sums[1],
                        n_hji_active=sums[2], max_abs_e=maxes[0],
                        max_prim_res=maxes[1], all_finite=-maxes[2])


def make_sharded_step(cfg: mpc_mod.MPCConfig, tube: trj.TrajectoryTube,
                      cache: hji_mod.HJICache, mesh,
                      use_tp_factor: "bool | None" = None):
    """The sharded batched control step over a (dp, tp) `mesh`.

    Returns step(carries, q0s, u0s, other_cars, ts) -> (new_carries, u3,
    diag, FleetMetrics), to be called by every rank with its local shards
    (`shard_batch_dp`): `mpc.mpc_step_batched` on them, the metrics
    reduced over the "dp" ranks.  The tube and the cache are replicated
    here.  `use_tp_factor` (default: on when the "tp" size is above 1 and
    the factor is "banded") shards the banded factor's columns over "tp"."""
    has_tp = mesh.size(mesh.mesh_dim_names.index("tp")) > 1
    if use_tp_factor is None:
        use_tp_factor = has_tp and cfg.solver.factor_method == "banded"
    if use_tp_factor:
        cfg = dataclasses.replace(
            cfg, solver=dataclasses.replace(cfg.solver, tp_axis="tp"))
    tube, cache = replicate((tube, cache), mesh)
    dp_group = mesh.get_group("dp")

    def step(carries, q0s, u0s, other_cars, ts):
        with axis_env(mesh):
            c2, u3, diag = mpc_mod.mpc_step_batched(
                cfg, tube, cache, carries, q0s, u0s, other_cars, ts)
        return c2, u3, diag, _fleet_metrics(diag, u3, ts, dp_group)

    return step


def shard_batch_dp(tree, mesh):
    """This rank's rows of a global batch tree: sharded over dp,
    replicated over tp."""
    return shard_batch(tree, mesh, "dp")
