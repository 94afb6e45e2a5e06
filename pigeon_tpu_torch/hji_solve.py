"""HJI value caches on disk.  Counterpart of the cache half of
`pigeon_tpu/hji_solve.py`: the npz format (`save_cache`, `load_cache`)
and the central-difference gradient field `grad_from_V` that builds a
cache's gradV when the file holds V only.  The value-iteration solver
that writes such caches is not ported.

The gradient is computed in numpy on the host: on the card the
(..., 7) temporaries of a fine grid would cost more device memory than
the cache itself.
"""

from __future__ import annotations

import numpy as np

from pigeon_tpu_torch import hji as hji_mod


def grad_from_V(V, knots):
    """Central-difference gradient field (V(i+1) - V(i-1)) / 2h on each
    axis, with the edge value replicated: (dims..., 7) float32."""
    V = np.asarray(V, np.float32)
    G = np.empty(V.shape + (7,), np.float32)
    for ax in range(V.ndim):
        h = float(knots[ax][1] - knots[ax][0])
        n = V.shape[ax]
        Vp = np.concatenate([np.take(V, np.arange(1, n), ax),
                             np.take(V, [n - 1], ax)], ax)
        Vp -= np.concatenate([np.take(V, [0], ax),
                              np.take(V, np.arange(0, n - 1), ax)], ax)
        G[..., ax] = Vp / (2.0 * h)
    return G


def save_cache(path: str, cache: hji_mod.HJICache,
               include_grad: bool = True):
    """Write `cache` as npz: V and gradV grid-shaped (gradV (dims..., 7)),
    knots_0 .. knots_6.  include_grad=False stores V and the knots only;
    `load_cache` then rebuilds gradV with `grad_from_V`."""
    arrs = {"V": cache.V.cpu().numpy().reshape(cache.dims)}
    if include_grad and cache.gradV is not None:
        arrs["gradV"] = cache.gradV.cpu().numpy().T.reshape(
            cache.dims + (7,))
    np.savez_compressed(
        path, **arrs,
        **{f"knots_{i}": k.cpu().numpy() for i, k in enumerate(cache.knots)})


def load_cache(path: str, device=None) -> hji_mod.HJICache:
    """The cache of an npz file on `device` (None: the card)."""
    d = np.load(path)
    knots = [d[f"knots_{i}"] for i in range(7)]
    V = d["V"]
    gradV = d["gradV"] if "gradV" in d.files else grad_from_V(V, knots)
    return hji_mod.make_cache(knots, V, gradV, device=device)
