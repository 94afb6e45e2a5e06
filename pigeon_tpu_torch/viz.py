"""Visualization: HJI value-function slices and closed-loop run plots.
Counterpart of `pigeon_tpu/viz.py` (the reference's rviz markers,
`src/rviz.jl:1-72`, and its PigeonViz node): a value-coloured (dE, dN)
slice of the 7-D value function at a relative state with its zero-level
contour, and trajectory and tracking-error views of a simulation log.
`hji_slice` samples on the cache's device through `hji.interpolate`;
the plots import matplotlib inside the function, so nothing else needs
it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import trajectory as trj


def _np(x) -> np.ndarray:
    return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x))


def hji_slice(cache: hji_mod.HJICache, rel_state, n_e: int = 41,
              n_n: int = 41, extent=None):
    """V over the (dE, dN) plane with the other 5 relative-state
    coordinates held at `rel_state` (the reference's
    `update_HJI_values_marker!` slice, src/rviz.jl:23-44); `extent` =
    (dE_lo, dE_hi, dN_lo, dN_hi), the grid's by default.  The axes are
    spaced in float64 and the points interpolated in the cache's dtype on
    its device.  Returns numpy (dE_axis (n_e,), dN_axis (n_n,), V (n_e,
    n_n))."""
    if extent is None:
        kE, kN = _np(cache.knots[0]), _np(cache.knots[1])
        extent = (kE[0], kE[-1], kN[0], kN[-1])
    extent = [float(v) for v in extent]
    dE = np.linspace(extent[0], extent[1], n_e)
    dN = np.linspace(extent[2], extent[3], n_n)
    x = np.broadcast_to(np.asarray(_np(rel_state), np.float64),
                        (n_e, n_n, 7)).copy()
    x[..., 0] = dE[:, None]
    x[..., 1] = dN[None, :]
    V, _ = hji_mod.interpolate(cache, torch.as_tensor(
        x, dtype=cache.V.dtype, device=cache.V.device))
    return dE, dN, _np(V)


def plot_hji_slice(cache: hji_mod.HJICache, rel_state, ax=None,
                   eps: float = 0.05, **slice_kw):
    """Value-coloured slice with the zero and eps level contours (the
    rviz values and contour marker pair, src/rviz.jl:23-69)."""
    import matplotlib.pyplot as plt

    dE, dN, V = hji_slice(cache, rel_state, **slice_kw)
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 5))
    finite = np.where(np.isfinite(V), V, np.nan)
    pc = ax.pcolormesh(dE, dN, finite.T, shading="auto", cmap="RdYlGn")
    for level, style in ((0.0, dict(colors="k", linewidths=2)),
                         (eps, dict(colors="b", linewidths=1,
                                    linestyles="--"))):
        # a slice that does not cross the level draws no contour
        if np.nanmin(finite) < level < np.nanmax(finite):
            ax.contour(dE, dN, finite.T, levels=[level], **style)
    rel = _np(rel_state)
    ax.plot([rel[0]], [rel[1]], "k*", markersize=12)
    ax.set_xlabel("dE (longitudinal, m)")
    ax.set_ylabel("dN (lateral, m)")
    ax.set_title("HJI value slice")
    plt.colorbar(pc, ax=ax, label="V")
    return ax


def plot_run(log, tube: Optional[trj.TrajectoryTube] = None,
             dt: float = 0.01, path: Optional[str] = None):
    """Closed-loop run summary of an `mpc.SimLog`: path overlay, lateral
    error, speed, commands, solver health; saved to `path` if given."""
    import matplotlib.pyplot as plt

    q, u = _np(log.q), _np(log.u)
    t = dt * np.arange(q.shape[0])
    fig, axes = plt.subplots(2, 3, figsize=(15, 8))

    ax = axes[0, 0]
    if tube is not None:
        n = int(tube.n_valid)
        ax.plot(_np(tube.E)[:n], _np(tube.N)[:n], "k--", lw=1,
                label="nominal")
    ax.plot(q[:, 0], q[:, 1], "b-", lw=1.5, label="vehicle")
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title("path (E, N)")

    panels = ((axes[0, 1], _np(log.diag.e), "lateral error e (m)"),
              (axes[0, 2], q[:, 3], "speed Ux (m/s)"),
              (axes[1, 0], u[:, 0], "steering delta (rad)"),
              (axes[1, 1], u[:, 1] + u[:, 2], "longitudinal force Fx (N)"),
              (axes[1, 2], _np(log.diag.iterations), "solver health"))
    for ax, y, title in panels:
        ax.plot(t, y)
        ax.set_title(title)
        ax.grid(True)
    ax2 = axes[1, 2].twinx()
    ax2.plot(t, _np(log.diag.converged), "g.", markersize=2,
             label="converged")

    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig
