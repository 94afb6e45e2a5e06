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
