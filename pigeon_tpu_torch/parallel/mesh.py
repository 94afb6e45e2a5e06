"""Scale-out: the batched closed-loop controller and scenario batching
over a device mesh.  Counterpart of `pigeon_tpu/parallel/mesh.py`.

The JAX package runs one controller process over global arrays sharded
on a `jax.sharding.Mesh`.  The port runs SPMD instead, the way
`torch.distributed` works:

- one process per card, `torch.distributed.init_process_group` called by
  the caller (NCCL on cards, gloo on CPU processes; nothing tells a
  program of a cluster, so the caller gives the address, the world size
  and the rank);
- a `torch.distributed.device_mesh.DeviceMesh` in place of the JAX mesh,
  with the JAX package's dimension names: "dp" here, ("dp", "tp") in
  `parallel/shard.py`;
- every rank calls each function with the same arguments.  A global batch
  tree passed in is identical on every rank; `shard_batch` keeps this
  rank's rows of its leading axis (the "dp" size must divide B, as JAX
  requires), `replicate` broadcasts every tensor of a tree (tube, cache)
  from the mesh's first rank so the ranks agree on it, and `gather_batch`
  all-gathers the local shards back into the global batch (JAX's global
  view, for tests and callers that want it);
- reductions over the fleet (`shard.FleetMetrics`,
  `montecarlo.MonteCarloSummary`) are global and identical on every rank;
  per-scenario outputs (states, logs, diagnostics, `PerScenario`) are the
  rank's shard;
- `BatchedController(mesh=)` keeps the semantics of the JAX package's jit
  over sharded arrays, one global batch: the solver's segment loop
  decides over every rank's shard (`solver.admm.global_batch`).
  `shard.make_sharded_step` keeps those of its shard_map: each rank's
  loop decides over its own shard.

All controller state is an explicit tree (`MPCCarry`), so scaling is
"shard the leading axis of everything": no cross-instance communication
on the hot path.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple

import torch

from pigeon_tpu_torch import discretize as dz
from pigeon_tpu_torch import dynamics as dyn
from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import mpc as mpc_mod
from pigeon_tpu_torch import trajectory as trj
from pigeon_tpu_torch.solver.admm import global_batch

# the other car of `step` and `rollout` when the caller gives none: far
# away, so the HJI filter stays inactive
FAR_CAR = (1e4, 1e4, 0.0, 0.0)


def tree_map(fn, tree):
    """`fn` on every tensor of a tree of named tuples, tuples, lists,
    dicts and dataclasses; other leaves (numbers, None, strings) as they
    are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    return tree


def _require_initialized():
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a device mesh needs torch.distributed: call "
            "torch.distributed.init_process_group (one process per card, "
            "e.g. under torchrun) before building or using a mesh")


def default_device_type() -> str:
    """"cuda" where a card is visible, else "cpu" (gloo processes)."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_mesh(n_devices: "int | None" = None, axis: str = "dp",
              device_type: "str | None" = None):
    """1-D scenario-parallel mesh over the world's ranks (`n_devices`, if
    given, must be the world size: one rank a card) on `device_type`
    ("cuda" or "cpu"; None: the card where one is visible).  Raises
    RuntimeError without an initialised process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    _require_initialized()
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the "
                         f"world's {world} ranks, one a card")
    return init_device_mesh(device_type or default_device_type(), (world,),
                            mesh_dim_names=(axis,))


def _axis(mesh, axis: str):
    """(process group, size, this rank's index) of a mesh dimension."""
    _require_initialized()
    return (mesh.get_group(axis),
            mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def shard_batch(tree, mesh, axis: str = "dp"):
    """This rank's rows of the leading axis of every tensor of a global
    batch tree (identical on every rank): the `axis` size must divide the
    batch, as in the JAX package (ValueError otherwise)."""
    _, size, idx = _axis(mesh, axis)

    def take(x):
        B = x.shape[0]
        if B % size:
            raise ValueError(f"batch {B} is not divisible by mesh axis "
                             f"{axis}={size}")
        n = B // size
        return x[idx * n:(idx + 1) * n]
    return tree_map(take, tree)


def replicate(tree, mesh):
    """Every tensor of `tree` broadcast from the mesh's first rank (along
    each mesh dimension in turn), so every rank holds the same values;
    the tensors come back contiguous, the caller's left as they were."""
    import torch.distributed as dist

    _require_initialized()

    def bcast(x):
        x = x.clone(memory_format=torch.contiguous_format)
        for name in mesh.mesh_dim_names:
            group = mesh.get_group(name)
            dist.broadcast(x, src=dist.get_global_rank(group, 0),
                           group=group)
        return x
    return tree_map(bcast, tree)


def gather_leading(x, group, size: int):
    """(size,) + x.shape: every member's `x` stacked in group-rank order
    (the collectives gather along dim 0; bools travel as uint8)."""
    import torch.distributed as dist

    xb = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(xb) for _ in range(size)]
    dist.all_gather(parts, xb, group=group)
    out = torch.stack(parts)
    return out.bool() if x.dtype == torch.bool else out


def gather_batch(tree, mesh, axis: str = "dp", dim: int = 0):
    """The global batch from every rank's shard: each tensor all-gathered
    over the `axis` ranks and concatenated along `dim` (0 for states and
    diagnostics, 1 for the (n_steps, B, ...) logs of `rollout`)."""
    group, size, _ = _axis(mesh, axis)

    def gather(x):
        parts = gather_leading(x.movedim(dim, 0), group, size)
        return parts.flatten(0, 1).movedim(0, dim)
    return tree_map(gather, tree)


class BatchState(NamedTuple):
    carry: mpc_mod.MPCCarry   # leading batch axis on every field
    q: torch.Tensor           # (B, 6) plant states
    u: torch.Tensor           # (B, 3) commands in effect


class BatchedController:
    """B scenarios in closed loop on the device of `tube`; `cache` None
    means the inactive cache.  `mesh` (a 1-D `DeviceMesh` of dimension
    "dp", `make_mesh`): the tube and the cache are replicated, `init_state`
    takes the global batch and keeps this rank's rows, `step` and `rollout`
    take the other car and the time as numbers or global (B, ...) tensors
    and shard them (the rank's own rows pass as they are), and the
    states, logs and diagnostics they return are the rank's shard.
    Without a mesh the whole batch runs here.

    With a mesh the step keeps the JAX package's semantics of one global
    batch (its jit over sharded arrays): the solver's segment loop takes
    its decisions over every rank's shard (`admm.global_batch`), so each
    scenario's result does not depend on the sharding, as long as the
    in-kernel exit groups (`lane_admm.GROUP` instances, the "pallas"
    tile) of the local batch are those of the global one: a local batch
    that is a multiple of them, as 8192 scenarios over up to 64 cards."""

    def __init__(self, cfg: mpc_mod.MPCConfig, tube: trj.TrajectoryTube,
                 cache: "hji_mod.HJICache | None" = None, mesh=None,
                 dt: float = 0.01):
        self.cfg = cfg
        self.dt = dt
        self.mesh = mesh
        self.tube = tube
        self.cache = (cache if cache is not None
                      else hji_mod.inactive_cache(device=tube.E.device))
        if mesh is not None:
            self.tube = replicate(self.tube, mesh)
            self.cache = replicate(self.cache, mesh)

    def _shard(self, x, B_local: int):
        """A global per-scenario tensor's rows for this rank; a number, a
        0-d tensor or the rank's own rows as they are."""
        if self.mesh is None or x.dim() == 0 or x.shape[0] == B_local:
            return x
        size = _axis(self.mesh, "dp")[1]
        if x.shape[0] != B_local * size:
            raise ValueError(
                f"a per-scenario input has {x.shape[0]} rows; the mesh "
                f"takes the global batch of {B_local * size} or this "
                f"rank's {B_local}")
        return shard_batch(x, self.mesh)

    def init_state(self, q0_batch, u0_batch=None) -> BatchState:
        """Cold carries for the scenarios' plant states q0_batch (B, 6),
        whose dtype and device the state takes; commands u0_batch (B, 3)
        or zeros.  With a mesh, the global batch in and this rank's rows
        out."""
        if self.mesh is not None:
            q0_batch, u0_batch = shard_batch((q0_batch, u0_batch), self.mesh)
        B = q0_batch.shape[0]
        carry = mpc_mod.init_carry(self.cfg, B, dtype=q0_batch.dtype,
                                   device=q0_batch.device)
        u0 = (torch.zeros_like(q0_batch[:, :3]) if u0_batch is None
              else u0_batch)
        return BatchState(carry=carry, q=q0_batch, u=u0)

    def _other(self, state: BatchState, other_car):
        if other_car is not None:
            return self._shard(other_car, state.q.shape[0])
        return state.q.new_tensor(FAR_CAR).expand(state.q.shape[0], 4)

    def _times(self, state: BatchState, t):
        q = state.q
        return self._shard(torch.as_tensor(t, dtype=q.dtype,
                                           device=q.device), q.shape[0])

    def step(self, state: BatchState, other_car=None, t=0.0):
        """One control period for every scenario: the MPC step, then the
        plant advances with the command that was in effect.  t: a number
        or a (B,) tensor.  Returns (new state, diagnostics)."""
        other_car = self._other(state, other_car)
        ts = self._times(state, t)
        q = state.q
        ts = ts.expand(q.shape[0]) if ts.dim() == 0 else ts
        with (contextlib.nullcontext() if self.mesh is None else
              global_batch(self.mesh.get_group("dp"))):
            carry, u3, diag = mpc_mod.mpc_step_batched(
                self.cfg, self.tube, self.cache, state.carry, q, state.u,
                other_car, ts)
        veh = self.cfg.veh
        ur = torch.cat([state.u[:, :1], state.u[:, 1:2] + state.u[:, 2:3],
                        torch.zeros_like(q[:, :4])], dim=-1)
        f = lambda qq, r: dyn.vehicle_ode(veh, "bicycle", qq, r[..., :2],
                                          r[..., 2:])
        q_next = dz.propagate(f, q, ur, self.dt, self.cfg.sim_substeps)
        return BatchState(carry=carry, q=q_next, u=u3), diag

    def advance_other(self, oc):
        """The other car one period on at constant velocity (heading
        measured from N, as the ego's)."""
        E, N, psi, V = oc.unbind(-1)
        return torch.stack([E - V * torch.sin(psi) * self.dt,
                            N + V * torch.cos(psi) * self.dt, psi, V],
                           dim=-1)

    def rollout(self, state: BatchState, n_steps: int, other_car=None,
                t0=0.0):
        """`n_steps` periods from `state`, the other car advancing at
        constant velocity; t0 a number or a (B,) tensor of per-scenario
        start times.  Returns (final state, (q_log, u_log, oc_log, diag)):
        the states and commands after each step (n_steps, B, ...), the
        other car during it and the stacked diagnostics, all on the
        device."""
        oc = self._other(state, other_car)
        t0 = self._times(state, t0)
        q_log, u_log, oc_log, diags = [], [], [], []
        for i in range(n_steps):
            state, diag = self.step(state, oc, t0 + i * self.dt)
            q_log.append(state.q)
            u_log.append(state.u)
            oc_log.append(oc)
            diags.append(diag)
            oc = self.advance_other(oc)
        diag = mpc_mod.StepDiagnostics(*[torch.stack(x)
                                         for x in zip(*diags)])
        return state, (torch.stack(q_log), torch.stack(u_log),
                       torch.stack(oc_log), diag)
