"""Carry the JAX package's state over to the port.

Each function takes numpy arrays (the caller applies `np.asarray` to the
JAX objects' fields) and builds the port's counterpart on a chosen device,
so a tube, an HJI cache, a fleet's controller state, a Monte-Carlo
scenario set, a batched closed-loop state or a controller runtime's state
can move from one
implementation to the other without this package importing either JAX or
`pigeon_tpu`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch.hji import HJICache
from pigeon_tpu_torch.montecarlo import ScenarioSet
from pigeon_tpu_torch.mpc import MPCCarry, SimLog, StepDiagnostics
from pigeon_tpu_torch.parallel.mesh import BatchState
from pigeon_tpu_torch.runtime.loop import ControllerRuntime, ToAutobox
from pigeon_tpu_torch.trajectory import (COLUMNS, LookupIndex,
                                         TrajectoryTube, tube_from_columns)


def _index(d: Mapping, device) -> LookupIndex:
    return LookupIndex(
        table=torch.as_tensor(np.array(d["table"]), dtype=torch.int64,
                              device=device),
        lo=float(np.asarray(d["lo"])), h=float(np.asarray(d["h"])),
        fixups=int(d["fixups"]))


def tube_from_numpy(arrays: Mapping, device=None,
                    dtype=torch.float32) -> TrajectoryTube:
    """`arrays`: the twelve knot columns (`trajectory.COLUMNS`), `n_valid`,
    and `t_idx` / `s_idx` as mappings with `table`, `lo`, `h`, `fixups`."""
    device = resolve_device(device)
    cols = {k: np.asarray(arrays[k], np.float64) for k in COLUMNS}
    return tube_from_columns(cols, int(np.asarray(arrays["n_valid"])),
                             _index(arrays["t_idx"], device),
                             _index(arrays["s_idx"], device), device, dtype)


def cache_from_numpy(arrays: Mapping, device=None) -> HJICache:
    """`arrays`: `knots` (7 arrays), flat `V` (P,), component-major
    `gradV` (7, P) or None, `dims` and `strides`."""
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    g = arrays.get("gradV")
    return HJICache(
        knots=tuple(torch.as_tensor(np.array(k), **f32)
                    for k in arrays["knots"]),
        V=torch.as_tensor(np.array(arrays["V"]).reshape(-1), **f32),
        gradV=None if g is None else torch.as_tensor(np.array(g), **f32),
        dims=tuple(int(d) for d in arrays["dims"]),
        strides=tuple(int(s) for s in arrays["strides"]))


def _fields_from_numpy(cls, arrays: Mapping, device, dtype):
    """A NamedTuple of tensors from its fields as numpy: floating fields
    in `dtype`, boolean and integer fields as they are."""
    out = {}
    for name in cls._fields:
        v = np.array(arrays[name])
        kind = dtype if np.issubdtype(v.dtype, np.floating) else None
        out[name] = torch.as_tensor(v, dtype=kind, device=device)
    return cls(**out)


def carry_from_numpy(arrays: Mapping, device=None,
                     dtype=torch.float32) -> MPCCarry:
    """`arrays`: the `MPCCarry` fields, of either formulation (q_prev
    (..., N, 6) coupled, (..., N, 4) decoupled), batched or of one
    vehicle."""
    return _fields_from_numpy(MPCCarry, arrays, resolve_device(device), dtype)


def simlog_from_numpy(arrays: Mapping, device=None,
                      dtype=torch.float32) -> SimLog:
    """`arrays`: `q` (n_steps, 6), `u` (n_steps, 3) and `diag`, a mapping
    of the stacked `StepDiagnostics` fields."""
    device = resolve_device(device)
    as_f = lambda v: torch.as_tensor(np.array(v), dtype=dtype, device=device)
    return SimLog(q=as_f(arrays["q"]), u=as_f(arrays["u"]),
                  diag=_fields_from_numpy(StepDiagnostics, arrays["diag"],
                                          device, dtype))


def scenarios_from_numpy(arrays: Mapping, device=None,
                         dtype=torch.float32) -> ScenarioSet:
    """`arrays`: the `ScenarioSet` fields q0 (B, 6), other0 (B, 4), t0
    (B,)."""
    return _fields_from_numpy(ScenarioSet, arrays, resolve_device(device),
                              dtype)


def batch_state_from_numpy(arrays: Mapping, device=None,
                           dtype=torch.float32) -> BatchState:
    """`arrays`: `carry`, a mapping of the `MPCCarry` fields, and the
    plant states `q` (B, 6) and commands `u` (B, 3)."""
    device = resolve_device(device)
    as_f = lambda v: torch.as_tensor(np.array(v), dtype=dtype, device=device)
    return BatchState(carry=carry_from_numpy(arrays["carry"], device, dtype),
                      q=as_f(arrays["q"]), u=as_f(arrays["u"]))


def runtime_state_from_numpy(runtime: ControllerRuntime,
                             arrays: Mapping) -> ControllerRuntime:
    """Give `runtime` (built with the same controllers) the state of
    another one, on `runtime`'s device, in float32: `arrays` holds `tube`
    (as `tube_from_numpy` takes it), `carries` (a mapping of each mode,
    "path" and "traj", to its `MPCCarry` fields of one vehicle),
    `other_car` (4,), `tracking_mode`, `time_offset`, `heartbeat` and
    `last_command` (a mapping of the `ToAutobox` fields).  Returns
    `runtime`."""
    device = runtime.device
    runtime.tube = tube_from_numpy(arrays["tube"], device)
    runtime.carries = {m: carry_from_numpy(arrays["carries"][m], device)
                       for m in runtime.cfgs}
    runtime.other_car = torch.as_tensor(np.array(arrays["other_car"]),
                                        dtype=torch.float32, device=device)
    runtime.tracking_mode = str(arrays["tracking_mode"])
    runtime.time_offset = float(arrays["time_offset"])
    runtime.heartbeat = int(arrays["heartbeat"])
    runtime.last_command = ToAutobox(**dict(arrays["last_command"]))
    return runtime
