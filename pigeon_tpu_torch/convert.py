"""Carry the JAX package's state over to the port.

Each function takes numpy arrays (the caller applies `np.asarray` to the
JAX objects' fields) and builds the port's counterpart on a chosen device,
so a tube, an HJI cache or a fleet's controller state can move from one
implementation to the other without this package importing either JAX or
`pigeon_tpu`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch.hji import HJICache
from pigeon_tpu_torch.mpc import MPCCarry
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


def carry_from_numpy(arrays: Mapping, device=None,
                     dtype=torch.float32) -> MPCCarry:
    """`arrays`: the `MPCCarry` fields of a batched carry."""
    device = resolve_device(device)
    out = {}
    for name in MPCCarry._fields:
        v = np.array(arrays[name])
        kind = torch.bool if v.dtype == np.bool_ else dtype
        out[name] = torch.as_tensor(v, dtype=kind, device=device)
    return MPCCarry(**out)
