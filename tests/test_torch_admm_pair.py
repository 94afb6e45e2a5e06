"""The dense ADMM kernel's pair build (`csrc/admm_large.cu`'s kernel
"admm_pair": an instance on a pair of blocks, each holding half of K^-1's
columns; a diagonal P whose K^-1 no one block holds: the sparse decoupled
QP at n = 245 in "mixed" and "high", and past n = 256) around the kernel,
on the CPU: which patterns take it and which keep or take other builds,
its shared-memory planner, its tile limit, its split of K^-1's columns,
its forms of A (the large build's), and the decoupled "pallas" pipeline's
calls through its pattern and pack, and through the large build's (the
kernel runs only on the card, in chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, straight_fleet, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import trajectory as JT
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import pallas_admm as TP

# chip_smoke.py's SPARSE_SOLVER, the decoupled fleet's options
PALLAS = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
              backend="pallas", factor_method="banded", scaling_iters=4,
              pallas_tile=4, pallas_precision="highest",
              pallas_check_inner=10, bf16_bulk_iters=0)


def _decoupled(hz=(10, 20)):
    return TM._a_pattern_for(TM.x1_decoupled_config(
        hz=THP(N_short=hz[0], N_long=hz[1]), solver=TSO(backend="pallas")))


def _coupled(condensed=False):
    return TM._a_pattern_for(TM.x1_coupled_config(
        condensed=condensed, solver=TSO(backend="pallas")))


@pytest.mark.parametrize("mode", TP.MODES)
def test_pair_build_at_n245(mode):
    """The decoupled layout's pattern (n = 245, widths 7 and 11) fits no
    narrow block.  The large block holds it where a lane's 16 register
    rows of K^-1 leave 126 rows in shared memory ("highest", "mixedk6",
    "bf16"); with the split K^-1 words' 8 ("mixed", "high") 182 rows stay
    there, too many, and the pattern takes the pair build.  At the (10,
    22) horizon (n = 261, past the large build's 256) every mode takes the
    pair build, whose block fits in "highest" (228,352 B; the other
    modes' words take it past 227 KB).  The mixed modes' rows split at
    their m_eq, which the
    decoupled QP does not have: its pipeline raises there, as the JAX
    package's."""
    pat = _decoupled()
    assert (pat.n, pat.m, pat.row_width, pat.col_width) == (245, 395, 7, 11)
    assert pat.build == "narrow"
    assert TP.block_bytes(pat) > TP.SMEM_MAX
    m_eq = 4 if mode in TP.MIXED_MODES else 0
    large = pat.as_build("large", m_eq)
    split_k = mode in ("mixed", "high")
    assert (TP.block_bytes(large, mode=mode) > TP.SMEM_MAX) == split_k
    got = pat.for_mode(mode, m_eq)
    assert got.build == ("pair" if split_k else "large")
    assert got.m_split == m_eq
    assert pat.for_mode(mode, m_eq) is got            # made once
    assert got.for_mode(mode, m_eq) is got
    assert TP.block_smem(got, mode=mode) <= TP.SMEM_MAX
    longer = _decoupled((10, 22))
    assert longer.n == 261 > TP.LARGE_N_MAX
    pair = longer.for_mode(mode, m_eq)
    assert pair.build == "pair" and pair.m_split == m_eq
    assert (TP.block_bytes(pair, mode=mode) <= TP.SMEM_MAX) == (
        mode == "highest")
    with pytest.raises(ValueError, match="n <= 256"):
        TP.block_smem(longer.as_build("large", m_eq), mode=mode)


@pytest.mark.parametrize("mode", TP.MODES)
def test_other_patterns_keep_their_builds(mode):
    """The layouts keep their builds: the sparse coupled layout the
    narrow one in "highest" and the large one in the split modes, the
    condensed one (dense P) the wide one, the decoupled layout at the (4,
    8) horizon (n = 69) the narrow or large one.  A random pattern at m =
    290 takes the narrow build in "highest" where its block fits (n = 193,
    205) and the large build in the split modes (its block fits at n =
    205 too, the register rows out of shared memory); at n = 245 the
    large build, or the pair where the split K^-1 words leave 8 register
    rows ("mixed", "high")."""
    m_eq = 128 if mode in TP.MIXED_MODES else 0
    sparse = _coupled().for_mode(mode, m_eq)
    assert sparse.build == ("narrow" if mode == "highest" else "large")
    assert _coupled(True).for_mode(mode, 38, dense_P=True).build == "wide"
    small = _decoupled((4, 8)).for_mode(mode, 4 if m_eq else 0)
    assert small.build == ("narrow" if mode == "highest" else "large")
    rng = np.random.default_rng(0)
    for n in (193, 205, 245):
        rows = np.repeat(np.arange(290), 4)
        cols = rng.integers(0, n, rows.size)
        cols[:n] = np.arange(n)
        pat = TP.EllPattern(rows, cols, 290, n)
        want = "narrow" if mode == "highest" else "large"
        if n == 245:
            want = "pair" if mode in ("mixed", "high") else "large"
        got = pat.for_mode(mode, m_eq)
        assert got.build == want, (n, mode)
        assert TP.block_smem(got, mode=mode) <= TP.SMEM_MAX


def test_dense_P_past_the_wide_build_raises():
    """A dense P never takes the pair build: at n = 245 its pattern keeps
    the narrow build (widths 7, 11) or the wide one (a row of 40), and
    each raises ValueError where its block does not fit; the pair's
    planner refuses a dense P too."""
    pat = _decoupled()
    narrow = pat.for_mode("highest", dense_P=True)
    assert narrow.build == "narrow"
    with pytest.raises(ValueError):
        TP.block_smem(narrow, dense_P=True)
    rows = np.concatenate([np.zeros(40, np.int64), pat._key // pat.n])
    cols = np.concatenate([np.arange(40), pat._key % pat.n])
    wide = TP.EllPattern(rows, cols, pat.m, pat.n).for_mode(
        "highest", dense_P=True)
    assert wide.build == "wide"
    with pytest.raises(ValueError):
        TP.block_smem(wide, dense_P=True)
    pair = pat.as_build("pair")
    with pytest.raises(ValueError):
        TP.block_smem(pair, dense_P=True)
    with pytest.raises(ValueError):
        TP.plan_smem_pair(245, 395, pair.slots, pair.lane_warps,
                          dense_P=True)


def test_pair_smem_planner():
    """Each block of the pair at the decoupled QP's shapes: all rows of
    half of K^-1's columns (128 of them at row stride 136) and the 2 n
    exchange words in place of the whole K^-1 at row stride 264 (which
    alone, 258,720 B, is over 227 KB) or the large block's 126 stored
    rows of it: 181,800 B in "highest", 187,900 B with the split modes'
    words, so one block an SM; ValueError past 227 KB."""
    pair = _decoupled().as_build("pair")
    args = (245, 395, pair.slots, pair.lane_warps)
    assert pair.slots == (1696, 1760) and pair.lane_warps == (13, 8)
    assert TP.plan_smem_pair(*args) == 181800
    assert TP.plan_smem_pair(*args, mode="high") == 187900
    assert TP.block_smem(pair) == 181800
    assert TP.block_smem(pair.as_build("pair"), mode="bf16") == 187900
    large = TP.smem_bytes_large(*args)
    assert 4 * 245 * TP.kld(245) == 258720 > TP.SMEM_MAX
    assert large - TP.plan_smem_pair(*args) == 4 * (
        126 * TP.kld(245) - 245 * TP.pair_ld(245) - 2 * 245)
    assert 2 * TP.plan_smem_pair(*args) > TP.SMEM_MAX   # one block an SM
    with pytest.raises(ValueError):
        TP.plan_smem_pair(400, 395, pair.slots, pair.lane_warps)


@pytest.mark.parametrize("n", [245, 300, 193, 129, 69, 17])
def test_pair_k_columns_cover_once(n):
    """The pair's K^-1 columns: block 0 the first `pair_cols0(n)` (whole
    16-column tasks, half of them rounded up), block 1 the rest, at most
    one task and a part fewer; each block's tasks read columns within its
    row stride `pair_ld(n)` (8 mod 32, 16-byte aligned rows), and the two
    put each of 0..n-1 once."""
    c0 = TP.pair_cols0(n)
    assert c0 % TP.LARGE_K_TASK == 0 and c0 < n
    ld = TP.pair_ld(n)
    assert ld % 32 == 8 and ld % 4 == 0
    put = []
    for first, cols in ((0, c0), (c0, n - c0)):
        tasks = -(-cols // TP.LARGE_K_TASK)
        assert tasks * TP.LARGE_K_TASK <= ld
        local = [t * TP.LARGE_K_TASK + cl * TP.LARGE_K_COLS + p
                 for t in range(tasks)
                 for cl in range(32 // TP.LARGE_K_PARTS) for p in range(4)]
        put += [first + k for k in local if k < cols]
    assert sorted(put) == list(range(n))
    assert 0 <= c0 - (n - c0) < 2 * TP.LARGE_K_TASK


def test_pair_forms_are_the_large_builds():
    """The pair build reads A as the large build does: the same packed
    slots, lane plans and pattern block, so its A products are the large
    build's (tests/test_torch_admm_large.py holds their order)."""
    pat = _decoupled()
    pair, large = pat.as_build("pair"), pat.as_build("large")
    for name in ("plan", "_slot_flat", "row_lanes", "col_lanes", "row_pos",
                 "col_pos"):
        np.testing.assert_array_equal(getattr(pair, name),
                                      getattr(large, name))
    assert pair.packed_shape(3) == large.packed_shape(3) == (3, 3456)
    assert TP.BUILD_KERNELS["pair"] == ("admm_pair", "admm_large.cu")


def _meta_call(pattern, tile):
    """`admm_iterations` on meta tensors of the decoupled QP's shapes (a
    meta tensor stands for the card: the wrapper goes on to the kernel's
    checks, never to the plain version)."""
    B, m, n = 8, 395, 245
    t = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                   device="meta")
    return TP.admm_iterations(
        t(B, n, n), t(B, m, n), t(B, n), t(B, m), t(B, m), t(B, m),
        t(B, n), t(B, m), t(B, m), 50, 1e-6, 1.6, tile=tile,
        pattern=pattern, A_packed=t(*pattern.packed_shape(B)))


@pytest.mark.parametrize("tile", [1, 2, 4, 5, 8])
def test_pair_tiles_at_most_4(tile):
    """A tile of the pair build is a cluster of 2 tile blocks, so at most
    PAIR_TILE_MAX = 4 instances (the portable cluster size 8 over 2):
    tiles 5..8, which the other builds take, raise ValueError; tiles up
    to 4 go on to the kernel's device checks."""
    assert TP.PAIR_TILE_MAX == 4
    pair = _decoupled().as_build("pair")
    if tile > TP.PAIR_TILE_MAX:
        with pytest.raises(ValueError, match="pair build's tile"):
            _meta_call(pair, tile)
    else:
        with pytest.raises(ValueError, match="CUDA tensor"):
            _meta_call(pair, tile)


def _pipeline_builds(monkeypatch, hz):
    """The decoupled "pallas" pipeline (3 vehicles at full width at the
    horizon `hz`, float32, chip_smoke.py's options) with every dense ADMM
    call made on the A that its build's pattern and pack carry: the
    pipeline hands the layout's pattern down, `_ell_form` puts it in the
    build of its mode, and its pack is scattered back from either slot
    order.  Returns each call's (build, tile, both halves give A exactly)
    and the solves without and with the pack."""
    cfg = dataclasses.replace(
        TM.x1_decoupled_config(hz=THP(N_short=hz[0], N_long=hz[1])),
        solver=TSO(**PALLAS))
    tube = convert.tube_from_numpy(
        tube_arrays(JT.straight_trajectory(60.0, 5.0, pad_to=32)),
        device="cpu", dtype=torch.float32)
    cache = convert.cache_from_numpy(cache_arrays(JH.inactive_cache()),
                                     device="cpu")
    B = 3
    q0, t0 = straight_fleet(B)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    qp, warm, _ = TM._pre_solve(
        cfg, tube, cache, TM.init_carry(cfg, B, device="cpu"), f32(q0),
        f32(np.zeros((B, 3))),
        f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4))), f32(t0))
    layout = TM._a_pattern_for(cfg)
    plain = TA.solve_qp_batched(qp, warm, cfg.solver, a_pattern=layout)

    def ell(A, a_pattern=None, mode="highest", m_eq=0, dense_P=False,
            shared=None):
        pattern = a_pattern.for_mode(mode, m_eq, dense_P)
        return dict(pattern=pattern, A_packed=TP.pack(A, pattern))

    calls, original = [], TP.admm_iterations

    def scatter(packed, pat):
        sr = pat.slots[0]
        out = []
        for half, pos, flat in ((packed[:, :sr], pat.row_pos, pat.csr_flat),
                                (packed[:, sr:], pat.col_pos, pat.csc_flat)):
            back = torch.zeros((B, pat.m * pat.n), dtype=packed.dtype)
            keep = torch.as_tensor(pos >= 0)
            back[:, torch.as_tensor(flat[pos[pos >= 0]])] = half[:, keep]
            out.append(back.view(B, pat.m, pat.n))
        return out

    def spy(Kinv, A, *args, pattern=None, A_packed=None, **kw):
        rows, cols = scatter(A_packed, pattern)
        calls.append((pattern.build, kw["tile"], torch.equal(rows, A)
                      and torch.equal(cols, A)))
        return original(Kinv, rows, *args, **kw)

    monkeypatch.setattr(TA, "_ell_form", ell)
    monkeypatch.setattr(TP, "admm_iterations", spy)
    packed = TA.solve_qp_batched(qp, warm, cfg.solver, a_pattern=layout)
    return calls, plain, packed


def test_decoupled_pipeline_through_the_pair_pack(monkeypatch):
    """The decoupled pipeline at the (10, 22) horizon (n = 261, past the
    large build) runs every dense ADMM call on the pair build's pattern
    and pack, whose A is the QP's exactly, and the solve is the one
    without the pack (the plain version, bit for bit)."""
    calls, plain, packed = _pipeline_builds(monkeypatch, (10, 22))
    assert calls and all(c == ("pair", 4, True) for c in calls)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)


def test_decoupled_pipeline_through_the_large_pack(monkeypatch):
    """The decoupled pipeline as chip_smoke.py's fleet runs it (n = 245,
    "highest") runs every dense ADMM call on the large build's pattern and
    pack, whose A is the QP's exactly, and the solve is the one without
    the pack (the plain version, bit for bit), as it was through the pair
    build's."""
    calls, plain, packed = _pipeline_builds(monkeypatch, (10, 20))
    assert calls and all(c == ("large", 4, True) for c in calls)
    for a, b in zip(plain, packed):
        assert torch.equal(a, b)
