"""The HJI value-function solver and its caches on disk.  Counterpart of
`pigeon_tpu/hji_solve.py`.

The solver computes the 7-D avoid value function by value iteration of
the avoid-set Hamilton-Jacobi variational inequality,

    V_{k+1}(x) = min( l(x),  V_k(x) + dt * (min(0, H(x, DV_k)) + diss) )
    H(x, p)    = max_u min_d  p . f_rel(x, u, d)

with f_rel the relative dynamics (`hji.relative_dynamics`), the analytic
optimizers `hji.optimal_control` / `optimal_disturbance`, a Lax-Friedrichs
dissipation (pointwise |f| by default) and the CFL time step.  l(x) is
the distance between the cars less a collision margin, so V < 0 marks
states from which the human can force a collision.  Each sweep is
elementwise work and axis shifts over the grid, in PyTorch operations;
no step of a sweep reads the device's values on the host (the step dt
stays a 0-d tensor), so the host waits only where the JAX package does:
once per `sweep_chunk` launch, for the horizon break.

`solve_hji_vi` sweeps the whole grid, or axis-0 slabs of it
(`slab_chunk`), which bounds the flow's temporaries at production grids;
`solve_hji_vi_sharded` splits axis 0 over the ranks of a
`torch.distributed` device mesh with a one-row halo exchange.  The cache
half (`save_cache`, `load_cache`, `grad_from_V`) reads and writes the npz
format; gradients are computed in numpy on the host, where the (..., 7)
temporaries of a fine grid cost host memory and not the card's.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from pigeon_tpu_torch import hji as hji_mod
from pigeon_tpu_torch import resolve_device
from pigeon_tpu_torch.config import VehicleParams

DEFAULT_BOUNDS = (
    (-48.0, 48.0),    # dE (longitudinal offset, ego frame)
    (-32.0, 32.0),    # dN (lateral offset)
    (-np.pi, np.pi),  # dpsi
    (1.0, 18.0),      # Ux
    (-3.0, 3.0),      # Uy
    (0.5, 18.0),      # V human
    (-1.5, 1.5),      # r
)
# The production grid (semantic order) and its storage order: grid axis i
# holds semantic axis PROD_AXIS_ORDER[i], so the grid is stored as
# (9, 9, 9, 9, 9, 32, 128) and `slab_chunk=1` cuts it into 9 slabs.
DEFAULT_SHAPE = (128, 32, 9, 9, 9, 9, 9)
PROD_AXIS_ORDER = (6, 5, 4, 3, 2, 1, 0)
PROTO_SHAPE = (15, 11, 9, 7, 5, 7, 5)

# the activation thresholds a solved cache is compared at
AGREEMENT_EPS = (0.05, 0.3, 0.6)


def _axis_diffs(V, h, axis):
    """One-sided forward/backward differences with edge replication."""
    n = V.shape[axis]
    Vp = torch.cat([V.narrow(axis, 1, n - 1), V.narrow(axis, n - 1, 1)],
                   axis)
    Vm = torch.cat([V.narrow(axis, 0, 1), V.narrow(axis, 0, n - 1)], axis)
    return (Vp - V) / h, (V - Vm) / h


def _halo_diffs(Vs_pad, h):
    """Axis-0 differences of a slab from its one-row halo'd copy."""
    Vs = Vs_pad[1:-1]
    return (Vs_pad[2:] - Vs) / h, (Vs - Vs_pad[:-2]) / h


def collision_distance(x7, margin: float):
    """l(x): separation distance minus margin (the target function)."""
    return torch.hypot(x7[..., 0], x7[..., 1]) - margin


def _flow_terms(Vs, diffs0, hs, flow_fn, start0):
    """The first pass of a sweep over a slab: central gradient, optimal
    flow f, Hamiltonian H = gradV . f and the slab's largest |f| per axis.
    `diffs0()` gives the axis-0 differences (edge-replicated or from a
    halo).  gradV is stored component-major: its (..., N) view has
    contiguous components."""
    ndim = Vs.ndim
    comps = []
    for ax in range(ndim):
        Dp, Dm = diffs0() if ax == 0 else _axis_diffs(Vs, hs[ax], ax)
        comps.append((Dp + Dm) * 0.5)
    gradV = torch.stack(comps, 0).movedim(0, -1)
    f = flow_fn(start0, gradV)
    H = torch.sum(gradV * f, dim=-1)
    alpha = torch.amax(torch.abs(f), dim=tuple(range(ndim)))
    return f, H, alpha


def _update(Vs, ls, diffs0, hs, f, H, alpha, dt, lo, lf, horizon, t):
    """The second pass: Lax-Friedrichs dissipation (pointwise |f| for
    lf="local", `alpha` per axis for "global"), the truncated update, the
    target and the floor, and the freeze past the horizon.  min(0, .)
    wraps only the analytic Hamiltonian: the dissipation acts as a
    diffusion on either side."""
    diss = None
    for ax in range(Vs.ndim):
        Dp, Dm = diffs0() if ax == 0 else _axis_diffs(Vs, hs[ax], ax)
        a = torch.abs(f[..., ax]) if lf == "local" else alpha[ax]
        term = a * (Dp - Dm) * 0.5
        diss = term if diss is None else diss + term
    V_new = torch.minimum(ls, Vs + dt * (torch.clamp(H, max=0.0) + diss))
    V_new = torch.maximum(V_new, lo)
    if horizon is not None:
        V_new = torch.where(t < horizon, V_new, Vs)
    return V_new


def _cfl_dt(cfl, alpha, hs):
    return cfl / torch.clamp(torch.sum(alpha / hs), min=1e-6)


def _sweep_body(V, l, hs_j, flow_fn, cfl, lo, lf, horizon, t, dt_in=None,
                start0=0, dt_cap=None):
    """One LLF sweep over the whole grid.  Returns (V_new, alpha, delta,
    dt).  dt_in None computes the CFL step from this sweep's alpha (cfl
    a 0-d tensor); a value is used verbatim.  dt_cap bounds the step (a
    0-d tensor)."""
    diffs0 = lambda: _axis_diffs(V, hs_j[0], 0)
    f, H, alpha = _flow_terms(V, diffs0, hs_j, flow_fn, start0)
    dt = _cfl_dt(cfl, alpha, hs_j) if dt_in is None else dt_in
    if dt_cap is not None:
        dt = torch.minimum(dt, dt_cap)
    V_new = _update(V, l, diffs0, hs_j, f, H, alpha, dt, lo, lf, horizon, t)
    delta = torch.amax(torch.abs(V_new - V))
    return V_new, alpha, delta, dt


def _pad_axis0(V):
    """Edge-replicated 1-cell halo along axis 0."""
    return torch.cat([V[:1], V, V[-1:]], dim=0)


def _slab_pass(V, l, hs_j, flow_fn, lo, lf, horizon, t, dt, slab_chunk):
    """One sweep over axis-0 slabs of `slab_chunk` rows at a fixed dt.
    Returns (V_new, alpha, delta); alpha is the grid's largest |f| per
    axis, for the next sweep's step.  lf="global" takes each slab's own
    alpha, as the JAX package's slab sweep does."""
    Vp = _pad_axis0(V)
    V_new = torch.empty_like(V)
    alphas = []
    for a in range(0, V.shape[0], slab_chunk):
        Vs_pad = Vp[a:a + slab_chunk + 2]
        Vs = Vs_pad[1:-1]
        diffs0 = lambda: _halo_diffs(Vs_pad, hs_j[0])
        f, H, alpha = _flow_terms(Vs, diffs0, hs_j, flow_fn, a)
        V_new[a:a + slab_chunk] = _update(
            Vs, l[a:a + slab_chunk], diffs0, hs_j, f, H, alpha, dt, lo, lf,
            horizon, t)
        alphas.append(alpha)
        del f, H
    alpha = torch.amax(torch.stack(alphas), dim=0)
    delta = torch.amax(torch.abs(V_new - V))
    return V_new, alpha, delta


def _constants(l, hs, cfl, floor, dt_fixed):
    """The sweep's constants as tensors on l's device, made once so that
    no sweep copies a host value to the card."""
    as_t = lambda x: torch.as_tensor(x, dtype=l.dtype, device=l.device)
    lo = torch.amin(l) if floor is None else as_t(floor)
    cap = None if dt_fixed is None else as_t(dt_fixed)
    return as_t(hs), lo, as_t(cfl), cap


def _run_sweeps(sweep, V, n_sweeps, sweep_chunk, horizon):
    """Run `sweep(V, t) -> (V, delta, dt)` up to n_sweeps times from
    pseudo-time 0 (a 0-d tensor on V's device).  With sweep_chunk > 0 and
    a horizon the host reads t after every sweep_chunk sweeps and stops
    once it has reached the horizon: frozen sweeps would only burn flow
    compute.  Returns (V, deltas, times)."""
    t = torch.zeros((), dtype=V.dtype, device=V.device)
    d_all, t_all = [], []
    for k in range(n_sweeps):
        V, delta, dt = sweep(V, t)
        t = t + dt
        d_all.append(delta)
        t_all.append(t)
        if (sweep_chunk > 0 and (k + 1) % sweep_chunk == 0
                and horizon is not None and float(t) >= horizon):
            break
    return V, torch.stack(d_all), torch.stack(t_all)


def solve_hji_vi(l, hs, flow_fn, n_sweeps: int, cfl: float = 0.5,
                 floor=None, sweep_chunk: int = 0, lf: str = "local",
                 horizon=None, slab_chunk: int = 0, dt_fixed=None):
    """Generic N-D avoid-set HJI-VI level-set solver on l's device.

        V_{k+1} = min( l, V_k + dt * min(0, H_LF) )

    l        : (k1, ..., kN) target function on the grid.
    hs       : length-N grid spacings.
    flow_fn  : (start0, gradV) -> f, the optimal-play dynamics; receives
               the global axis-0 offset of the slab being processed (0
               for whole-grid sweeps) and the value-gradient stack
               (..., N); returns the flow field (..., N) under u*
               (maximizing p.f) and d* (minimizing).
    floor    : mathematical lower bound of V (defaults to min(l)).
    sweep_chunk: 0 runs all sweeps without reading the device; k > 0
               reads the pseudo-time on the host after every k sweeps
               and stops once it has reached `horizon`.
    lf       : "local" (default): pointwise |f| dissipation; "global":
               the per-axis grid max.  The CFL step is global either way.
    horizon  : optional pseudo-time horizon T (seconds): updates freeze
               once the cumulative pseudo-time reaches T.
    slab_chunk: 0 sweeps the whole grid at once; k > 0 sweeps axis 0 in
               k-row slabs (shape[0] % k == 0), bounding the flow's
               temporaries to a slab.  The CFL step then uses the
               previous sweep's grid-max |f| scaled by 0.9, seeded by
               one alpha-only pass.
    dt_fixed : optional cap on the step.

    Returns (V, deltas, times): the value grid, per-sweep sup-norm
    updates, and the cumulative pseudo-time after each sweep.
    """
    hs_j, lo, cfl_t, cap = _constants(l, hs, cfl, floor, dt_fixed)
    if slab_chunk > 0:
        if l.shape[0] % slab_chunk != 0:
            raise ValueError(
                f"shape[0]={l.shape[0]} not divisible by "
                f"slab_chunk={slab_chunk}")
        cfl09 = torch.as_tensor(0.9 * cfl, dtype=l.dtype, device=l.device)
        zero = torch.zeros_like(lo)
        _, alpha, _ = _slab_pass(l, l, hs_j, flow_fn, lo, lf, horizon, zero,
                                 zero, slab_chunk)

        def sweep(V, t):
            nonlocal alpha
            dt = _cfl_dt(cfl09, alpha, hs_j)
            if cap is not None:
                dt = torch.minimum(dt, cap)
            V, alpha, delta = _slab_pass(V, l, hs_j, flow_fn, lo, lf,
                                         horizon, t, dt, slab_chunk)
            return V, delta, dt
    else:
        def sweep(V, t):
            V, _, delta, dt = _sweep_body(V, l, hs_j, flow_fn, cfl_t, lo,
                                          lf, horizon, t, dt_cap=cap)
            return V, delta, dt
    return _run_sweeps(sweep, l, n_sweeps, sweep_chunk, horizon)


def solve_hji_vi_sharded(l, hs, flow_fn, n_sweeps: int, mesh,
                         axis_name: str = "dp", cfl: float = 0.5,
                         floor=None, sweep_chunk: int = 0,
                         lf: str = "local", horizon=None, dt_fixed=None):
    """`solve_hji_vi`'s whole-grid sweep with the grid's axis 0 split over
    the ranks of `mesh`'s dimension `axis_name` (a
    `torch.distributed.device_mesh.DeviceMesh`).  Every rank of that
    dimension calls this with the same arguments (l whole, on its device)
    and keeps only its axis-0 slab.  Each sweep sends its edge rows to its
    neighbours and receives theirs (the grid's first and last rank
    replicate their own edge rows; world size 1 exchanges nothing), and
    takes the max of alpha and of delta over the ranks, so the step and
    the update are the whole-grid sweep's.  Returns (V, deltas, times)
    with the whole V gathered on every rank."""
    import torch.distributed as dist

    group = mesh.get_group(axis_name)
    ndev = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if l.shape[0] % ndev != 0:
        raise ValueError(f"shape[0]={l.shape[0]} not divisible by "
                         f"mesh axis {axis_name}={ndev}")
    idx = mesh.get_local_rank(axis_name)
    shard_len = l.shape[0] // ndev
    start0 = idx * shard_len
    peer = lambda i: dist.get_global_rank(group, i)
    hs_j, lo, cfl_t, cap = _constants(l, hs, cfl, floor, dt_fixed)
    ls = l[start0:start0 + shard_len].clone()

    def halo(V):
        """V with the neighbours' edge rows (own edge rows at the grid's
        ends) on both sides of axis 0."""
        v_lo, v_hi = V[:1].clone(), V[-1:].clone()
        ops = []
        if idx > 0:
            ops += [dist.P2POp(dist.isend, V[:1].contiguous(), peer(idx - 1),
                               group),
                    dist.P2POp(dist.irecv, v_lo, peer(idx - 1), group)]
        if idx < ndev - 1:
            ops += [dist.P2POp(dist.isend, V[-1:].contiguous(),
                               peer(idx + 1), group),
                    dist.P2POp(dist.irecv, v_hi, peer(idx + 1), group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.cat([v_lo, V, v_hi], dim=0)

    def sweep(V, t):
        Vs_pad = halo(V)
        diffs0 = lambda: _halo_diffs(Vs_pad, hs_j[0])
        f, H, alpha = _flow_terms(V, diffs0, hs_j, flow_fn, start0)
        dist.all_reduce(alpha, op=dist.ReduceOp.MAX, group=group)
        dt = _cfl_dt(cfl_t, alpha, hs_j)
        if cap is not None:
            dt = torch.minimum(dt, cap)
        V_new = _update(V, ls, diffs0, hs_j, f, H, alpha, dt, lo, lf,
                        horizon, t)
        delta = torch.amax(torch.abs(V_new - V))
        dist.all_reduce(delta, op=dist.ReduceOp.MAX, group=group)
        return V_new, delta, dt

    V, deltas, times = _run_sweeps(sweep, ls, n_sweeps, sweep_chunk,
                                   horizon)
    parts = [torch.empty_like(V) for _ in range(ndev)]
    dist.all_gather(parts, V.contiguous(), group=group)
    return torch.cat(parts, dim=0), deltas, times


def vehicle_problem(veh: VehicleParams, bounds: Sequence = DEFAULT_BOUNDS,
                    shape: Sequence[int] = DEFAULT_SHAPE,
                    margin: float = 3.0, fx_samples: int = 15,
                    axis_order=None, dtype=torch.float32, device=None):
    """The 7-D avoid game on a grid, as `solve_hji` hands it to the
    solvers: (l, hs, flow, knots).  Grid axis i holds semantic axis
    axis_order[i]; bounds and shape are semantic.  l is built from the dE
    and dN knot vectors by broadcasting; `flow(start0, gradV)` builds the
    coordinates of the slab that starts at grid row start0 from the 1-D
    knot vectors, takes gradV per grid axis and returns f per grid axis.
    knots are the semantic float64 numpy knots."""
    device = resolve_device(device)
    order = (tuple(axis_order) if axis_order is not None
             else tuple(range(7)))
    inv = tuple(order.index(j) for j in range(7))  # semantic -> grid pos
    knots = [np.linspace(lo, hi, k) for (lo, hi), k in zip(bounds, shape)]
    hs_sem = [float(k[1] - k[0]) for k in knots]
    hs = [hs_sem[order[i]] for i in range(7)]      # grid-axis spacings
    knots_g = [torch.as_tensor(knots[order[i]], dtype=dtype, device=device)
               for i in range(7)]
    dims = [len(k) for k in knots_g]

    def along(j):
        """Semantic axis j's knots, shaped to broadcast over the grid."""
        view = [1] * 7
        view[inv[j]] = dims[inv[j]]
        return knots_g[inv[j]].reshape(view)

    dEdN = torch.stack(torch.broadcast_tensors(along(0), along(1)), dim=-1)
    l = collision_distance(dEdN, margin).expand(dims).contiguous()

    def flow(start0, gradV):
        # component-major stacks: each component a contiguous slab
        grids = torch.meshgrid(knots_g[0][start0:start0 + gradV.shape[0]],
                               *knots_g[1:], indexing="ij")
        X = torch.stack([grids[inv[j]] for j in range(7)], 0).movedim(0, -1)
        g_sem = torch.stack([gradV[..., inv[j]] for j in range(7)],
                            0).movedim(0, -1)
        uR = hji_mod.optimal_control(veh, X, g_sem, "max",
                                     n_samples=fx_samples)
        uH = hji_mod.optimal_disturbance(veh, X, g_sem, "min")
        f_sem = hji_mod.relative_dynamics(veh, X, uR, uH)     # (..., 7)
        return torch.stack([f_sem[..., order[i]] for i in range(7)],
                           0).movedim(0, -1)               # grid order

    return l, hs, flow, knots


def solve_hji(veh: VehicleParams,
              bounds: Sequence = DEFAULT_BOUNDS,
              shape: Sequence[int] = DEFAULT_SHAPE,
              margin: float = 3.0,
              n_sweeps: int = 400,
              cfl: float = 0.5,
              fx_samples: int = 15,
              sweep_chunk: int = 0,
              lf: str = "local",
              horizon_s: "float | None" = None,
              slab_chunk: int = 0,
              mesh=None,
              mesh_axis: str = "dp",
              dt_fixed=None,
              axis_order=None,
              with_grad: bool = True,
              dtype=torch.float32,
              device=None,
              ) -> "tuple[hji_mod.HJICache, np.ndarray, np.ndarray]":
    """Solve the avoid HJI-VI on a 7-D grid on `device` (None: the card).

    slab_chunk > 0 bounds the device memory of a sweep (axis-0 slabs);
    mesh != None splits axis 0 over the mesh's `mesh_axis` ranks instead
    (`solve_hji_vi_sharded`; every rank calls this and gets the whole
    cache); the two cannot be combined.  with_grad=False skips the
    gradient field (a V-only cache; `load_cache` rebuilds gradients).
    axis_order: storage permutation, grid axis i holds semantic axis
    axis_order[i] (bounds/shape stay semantic; the returned cache is
    always semantic).  The value grid is solved in `dtype`; the cache is
    float32 (`hji.make_cache`).

    Returns (cache, deltas, times): the `HJICache` plus the per-sweep
    sup-norm updates and cumulative pseudo-times as numpy arrays."""
    if mesh is not None and slab_chunk > 0:
        raise ValueError("mesh and slab_chunk cannot be combined")
    device = resolve_device(device)
    l, hs, flow, knots = vehicle_problem(veh, bounds, shape, margin,
                                         fx_samples, axis_order, dtype,
                                         device)
    # mathematical floor: V = min-over-time of l >= min(l) = -margin
    if mesh is not None:
        V, deltas, times = solve_hji_vi_sharded(
            l, hs, flow, n_sweeps, mesh, axis_name=mesh_axis, cfl=cfl,
            floor=-margin, sweep_chunk=sweep_chunk, lf=lf,
            horizon=horizon_s, dt_fixed=dt_fixed)
    else:
        V, deltas, times = solve_hji_vi(l, hs, flow, n_sweeps, cfl,
                                        floor=-margin,
                                        sweep_chunk=sweep_chunk, lf=lf,
                                        horizon=horizon_s,
                                        slab_chunk=slab_chunk,
                                        dt_fixed=dt_fixed)
    del l
    if axis_order is not None:
        inv = tuple(tuple(axis_order).index(j) for j in range(7))
        V = V.permute(inv)
    V_np = V.contiguous().cpu().numpy()
    del V
    gradV_np = grad_from_V(V_np, knots) if with_grad else None
    cache = hji_mod.make_cache(knots, V_np, gradV_np, device=device)
    return cache, deltas.cpu().numpy(), times.cpu().numpy()


def value_agreement(V, V_ref, eps: Sequence[float] = AGREEMENT_EPS) -> dict:
    """How far the values V lie from V_ref (numpy, same points), by the
    measures of scripts/hji_production.py's `_pair_stats`: over the points
    where both are finite, the mean and 99th percentile of |V - V_ref|;
    and for each eps, each side's share of points with V <= eps (the
    filter's activation) and the share where the two agree."""
    V, V_ref = np.asarray(V, np.float64), np.asarray(V_ref, np.float64)
    fin = np.isfinite(V) & np.isfinite(V_ref)
    dV = np.abs(V[fin] - V_ref[fin]) if fin.any() else np.zeros(1)
    rec = dict(points=int(V.size), finite_frac=float(fin.mean()),
               V_mean_abs_delta=float(dV.mean()),
               V_p99_abs_delta=float(np.percentile(dV, 99)),
               V_max_abs_delta=float(dV.max()))
    for e in eps:
        act, act_ref = V <= e, V_ref <= e
        rec[f"eps_{e}"] = dict(active_frac=float(act.mean()),
                               active_frac_ref=float(act_ref.mean()),
                               activation_agreement=float(
                                   (act == act_ref).mean()))
    return rec


def pursuit_target(shape: Sequence[int], half: float = 8.0,
                   margin: float = 1.0):
    """The isotropic pursuit game's target on a 2-D grid of `shape` over
    [-half, half]^2 (tests/test_hji_validation.py): l = |p| - margin
    (float64 numpy) and the grid spacings."""
    knots = [np.linspace(-half, half, n) for n in shape]
    X = np.stack(np.meshgrid(*knots, indexing="ij"), axis=-1)
    return (np.hypot(X[..., 0], X[..., 1]) - margin,
            [float(k[1] - k[0]) for k in knots])


def pursuit_flow(speed: float):
    """The pursuit game's optimal flow -speed p / |p| as a flow function
    (start0, gradV) -> f.  It has no argmax, so two programs of one sweep
    agree to roundoff."""
    def flow(start0, gradV):
        nrm = torch.clamp(torch.linalg.vector_norm(gradV, dim=-1,
                                                   keepdim=True), min=1e-12)
        return -speed * gradV / nrm
    return flow


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
