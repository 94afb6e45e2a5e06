"""The dense ADMM kernel's wide build (`csrc/admm_wide.cu`) around the
kernel, on the CPU: its compact pattern of the hard condensed QP's layout,
`pack`, the build plan, the shared-memory planner, the lane plans, and the
wide build's summation order emulated in numpy from the pattern block the
kernel reads (the kernel runs only on the card, in chip_smoke.py)."""

import numpy as np
import pytest
import torch

from torch_port_helpers import oval_fleet, t64
from pigeon_tpu_torch import hji as TH
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch import trajectory as TT
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions
from pigeon_tpu_torch.solver import pallas_admm as TP

LIVE = (5, 10)


def _cfg(hz=LIVE, condensed=True, **solver):
    return TM.x1_coupled_config(
        hz=THP(N_short=hz[0], N_long=hz[1]), condensed=condensed,
        solver=SolverOptions(**dict(dict(backend="pallas"), **solver)))


def _pattern(hz=LIVE, condensed=True):
    return TM._a_pattern_for(_cfg(hz, condensed))


def _fleet_A(B=2, seed=4):
    """The port's assembled condensed A (float64) of one cold step of an
    oval fleet at the live horizon."""
    cfg = _cfg()
    q0, t0, cols = oval_fleet(B, seed=seed)
    tube = TT.make_tube(**cols, pad_to=1024, device="cpu",
                        dtype=torch.float64)
    carry = TM.init_carry(cfg, B, dtype=torch.float64, device="cpu")
    oc = t64(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, _, _ = TM._pre_solve(cfg, tube, TH.inactive_cache(device="cpu"),
                             carry, t64(q0), t64(np.zeros((B, 3))), oc,
                             t64(t0))
    return qp.A


def _decode(pattern):
    """The pattern block as the kernel reads it: each product's lane
    descriptors and runs, and each slot's column (row) index."""
    rw, cw = pattern.lane_warps
    sr, sc = pattern.slots
    plan = pattern.plan
    rl, rr = plan[:32 * rw], plan[32 * rw:64 * rw]
    cl, cr = plan[64 * rw:64 * rw + 32 * cw], plan[64 * rw + 32 * cw:
                                                   64 * (rw + cw)]
    shorts = plan[64 * (rw + cw):].view(np.int16)
    return ((rl, rr, shorts[:sr]), (cl, cr, shorts[sr + sr % 2:][:sc]))


def _lanes(desc, runs):
    """(segment, g, G, first slot, count) of each lane."""
    d, r = desc.astype(np.int64), runs.astype(np.int64)
    return np.stack([d & 0xFFFF, (d >> TP.LANE_G_SHIFT) & 31,
                     (d >> TP.LANE_SIZE_SHIFT) & 63, r & 0xFFFF, r >> 16],
                    axis=1)


def _group_products(desc, runs, vals, idx, v):
    """The wide build's A products in float32 (multiply, then add): each
    lane sums its run's slots in order, then the group's tree adds lane g
    + d's sum to lane g's for d = 1, 2, 4, ... (`group_sum`)."""
    out = {}
    lanes = _lanes(desc, runs)
    for w in range(lanes.shape[0] // 32):
        ln = lanes[32 * w:32 * w + 32]
        acc = np.zeros(32, np.float32)
        for lane, (_, _, _, first, count) in enumerate(ln):
            for i in range(count):
                slot = first + 32 * i
                acc[lane] = np.float32(acc[lane] + np.float32(
                    vals[slot] * v[idx[slot]]))
        d = 1
        while d < ln[:, 2].max():
            shifted = np.concatenate([acc[d:], acc[32 - d:]])
            add = ((ln[:, 1] & (2 * d - 1)) == 0) & (ln[:, 1] + d < ln[:, 2])
            acc = np.where(add, (acc + shifted).astype(np.float32), acc)
            d *= 2
        for lane, (seg, g, _, _, _) in enumerate(ln):
            if seg != TP.LANE_IDLE and g == 0:
                out[int(seg)] = acc[lane]
    return out


def test_compact_pattern_of_the_condensed_layout():
    """The layout's pattern takes the wide build: as many nonzeros as its
    narrow form (3,105), each once in row order and once in column order,
    and each read by exactly one row slot and one column slot, whose index
    in the kernel's pattern block is its column (row)."""
    pat = _pattern()
    narrow = pat.as_build("narrow")
    assert pat.build == "wide" and narrow.build == "narrow"
    assert pat.nnz == narrow.nnz == 3105
    lay = TM._layout(_cfg()).lay
    key = np.unique(lay._row_cat * lay.n + lay._col_cat)
    np.testing.assert_array_equal(pat.csr_flat, key)
    np.testing.assert_array_equal(np.sort(pat.csc_flat), key)
    assert (np.diff(pat.csc_flat % pat.n) >= 0).all()
    for pos in (pat.row_pos, pat.col_pos):
        np.testing.assert_array_equal(np.sort(pos[pos >= 0]),
                                      np.arange(pat.nnz))
    (_, _, ridx), (_, _, cidx) = _decode(pat)
    np.testing.assert_array_equal(ridx[pat.row_pos >= 0],
                                  pat.csr_col[pat.row_pos[pat.row_pos >= 0]])
    np.testing.assert_array_equal(cidx[pat.col_pos >= 0],
                                  pat.csc_row[pat.col_pos[pat.col_pos >= 0]])
    assert pat.lane_warps == (9, 7) and pat.slots == (3456, 3360)


def test_pack_scatters_back_to_A():
    """`pack` into the wide pattern and a scatter back from either half
    give A exactly, on an A whose static nonzeros are zero in some
    instances; entries outside the pattern are dropped."""
    pat = _pattern()
    rng = np.random.default_rng(1)
    rows, cols = pat.csr_flat // pat.n, pat.csr_flat % pat.n
    vals = rng.normal(size=(3, pat.nnz)) * (rng.random((3, pat.nnz)) < 0.6)
    A = torch.zeros((3, pat.m, pat.n), dtype=torch.float64)
    A[:, torch.as_tensor(rows), torch.as_tensor(cols)] = t64(vals)
    packed = TP.pack(A, pat)
    assert packed.shape == pat.packed_shape(3) == (3, sum(pat.slots))
    sr = pat.slots[0]
    for half, pos, flat in ((packed[:, :sr], pat.row_pos, pat.csr_flat),
                            (packed[:, sr:], pat.col_pos, pat.csc_flat)):
        back = torch.zeros((3, pat.m * pat.n), dtype=torch.float64)
        keep = torch.as_tensor(pos >= 0)
        back[:, torch.as_tensor(flat[pos[pos >= 0]])] = half[:, keep]
        assert torch.equal(back.view_as(A), A)
    outside = torch.ones(pat.m * pat.n, dtype=torch.float64)
    outside[torch.as_tensor(pat.csr_flat)] = 0.0
    assert torch.equal(TP.pack(A + outside.view(pat.m, pat.n), pat)[
        :, torch.as_tensor(np.concatenate([pat.row_pos, pat.col_pos]) >= 0)],
        packed[:, torch.as_tensor(np.concatenate([pat.row_pos,
                                                  pat.col_pos]) >= 0)])


@pytest.mark.parametrize("widths, build", [
    ((11, 15), "narrow"), ((32, 32), "narrow"), ((33, 10), "wide"),
    ((10, 33), "wide"), ((39, 79), "wide")], ids=str)
def test_plan_build_threshold(widths, build):
    assert TP.plan_build(*widths) == build


@pytest.mark.parametrize("case, build", [
    ("condensed fleet, dense P", "wide"),
    ("condensed unbatched route, tile 1", "wide"),
    ("condensed (4, 8)", "wide"), ("condensed (2, 3)", "narrow"),
    ("sparse", "narrow"), ("sparse (4, 8)", "narrow")], ids=str)
def test_plan_build_of_the_paths(case, build):
    """The condensed layout's widths (39, 79) take the wide build on both
    of its routes (the fleet's dense-P pipeline, the unbatched route's
    tile-1 call with the default options); the sparse layout's (11, 15)
    the narrow one."""
    cfg = {"condensed fleet, dense P": _cfg(pallas_tile=4),
           "condensed unbatched route, tile 1": _cfg(),
           "condensed (4, 8)": _cfg((4, 8)),
           "condensed (2, 3)": _cfg((2, 3)),
           "sparse": _cfg(condensed=False),
           "sparse (4, 8)": _cfg((4, 8), condensed=False)}[case]
    assert TM._a_pattern_for(cfg).build == build


def test_wide_smem_planner():
    """`plan_smem_wide` at the condensed QP's shapes, in "highest" and a
    split mode (four vectors' words more); `block_smem` gives a dense P
    the same bytes as a diagonal one (the wide build reads PuD from device
    memory); ValueError past 227 KB; the (5, 12) horizon the narrow build
    refuses with its dense P fits."""
    pat = _pattern()
    args = (103, 200, pat.slots, pat.lane_warps)
    assert TP.plan_smem_wide(*args) == 97164
    assert TP.plan_smem_wide(*args, mode="mixed") == 97164 + 4 * (
        2 * 103 + 2 * 200)
    assert TP.block_smem(pat, dense_P=True) == TP.block_smem(pat) == 97164
    assert TP.kld(103) == 104 and TP.kld(193) == 200 and TP.kld(8) == 8
    with pytest.raises(ValueError):
        TP.plan_smem_wide(230, 290, pat.slots, pat.lane_warps)
    assert TP.plan_smem_wide(190, 290, pat.slots, pat.lane_warps) \
        <= TP.SMEM_MAX
    long = _pattern((5, 12))
    with pytest.raises(ValueError):
        TP.plan_smem(long.n, long.m, long.row_width, long.col_width,
                     dense_P=True)
    assert TP.block_smem(long, dense_P=True) <= TP.SMEM_MAX


@pytest.mark.parametrize("source", ["rows", "columns", "random"])
def test_lane_plan_covers_each_segment(source):
    """Each segment is one group of G <= 32 contiguous lanes of one lane
    warp, lane g = 0..G-1 in order, and lane g's run is the segment's g-th
    run of ceil(len / G) consecutive positions: together they read each
    position once."""
    pat = _pattern()
    if source == "random":
        lengths = np.random.default_rng(7).integers(0, 90, 150)
        starts = np.concatenate([[0], np.cumsum(lengths)])
        desc = TP.lane_plan(lengths)
        runs, pos = TP._slices(desc, starts)
    else:
        rows = source == "rows"
        starts = pat.csr_start if rows else pat.csc_start
        lengths = np.diff(starts)
        desc, runs = ((pat.row_lanes, pat.row_runs) if rows
                      else (pat.col_lanes, pat.col_runs))
        pos = pat.row_pos if rows else pat.col_pos
    lanes = _lanes(desc, runs)
    seen = np.zeros(starts[-1], int)
    for seg, length in enumerate(lengths):
        at = np.flatnonzero(lanes[:, 0] == seg)
        G = lanes[at[0], 2]
        assert 1 <= G <= 32 and at.size == G
        np.testing.assert_array_equal(at, at[0] + np.arange(G))
        assert at[0] // 32 == at[-1] // 32
        np.testing.assert_array_equal(lanes[at, 1], np.arange(G))
        run = -(-length // G)
        for g, lane in enumerate(at):
            first, count = lanes[lane, 3], lanes[lane, 4]
            got = pos[first + 32 * np.arange(count)]
            lo = min(starts[seg] + g * run, starts[seg + 1])
            np.testing.assert_array_equal(
                got, np.arange(lo, min(lo + run, starts[seg + 1])))
            seen[got] += 1
    assert (seen == 1).all()
    idle = lanes[:, 0] == TP.LANE_IDLE
    assert (lanes[idle, 2] == 1).all() and (lanes[idle, 4] == 0).all()


def test_wide_products_in_their_order():
    """A'w, A x and rhs' K^-1 summed as the wide build sums them (decoded
    from the pattern block and the packed values, float32, without fused
    multiply-adds) lie within float32 rounding of the float64 products,
    on a fleet's condensed A."""
    pat = _pattern()
    A64 = _fleet_A()[0]
    A = A64.to(torch.float32)
    vals = TP.pack(A[None], pat)[0].numpy()
    sr = pat.slots[0]
    rng = np.random.default_rng(5)
    x = rng.normal(size=pat.n).astype(np.float32)
    w = rng.normal(size=pat.m).astype(np.float32)
    (rl, rr, ridx), (cl, cr, cidx) = _decode(pat)
    ax = _group_products(rl, rr, vals[:sr], ridx, x)
    atw = _group_products(cl, cr, vals[sr:], cidx, w)
    assert sorted(ax) == list(range(pat.m))
    assert sorted(atw) == list(range(pat.n))
    An = A.double().numpy()
    eps = np.finfo(np.float32).eps
    for got, exact, scale, length in (
            (ax, An @ x, np.abs(An) @ np.abs(x), pat.row_width),
            (atw, An.T @ w, np.abs(An).T @ np.abs(w), pat.col_width)):
        got = np.array([got[i] for i in range(exact.size)], np.float64)
        assert (np.abs(got - exact) <= 2 * length * eps * scale).all()
    # the K^-1 product: four parts of k_run consecutive rows, then
    # (s0 + s1) + (s2 + s3)
    n = pat.n
    K = rng.normal(size=(n, n)).astype(np.float32)
    run = (-(-n // 4)) | 1
    parts = np.zeros((4, n), np.float32)
    for p in range(4):
        for j in range(p * run, min((p + 1) * run, n)):
            parts[p] = (parts[p] + (x[j] * K[j]).astype(np.float32)).astype(
                np.float32)
    xt = ((parts[0] + parts[1]).astype(np.float32)
          + (parts[2] + parts[3]).astype(np.float32)).astype(np.float32)
    exact = x.astype(np.float64) @ K.astype(np.float64)
    scale = np.abs(x.astype(np.float64)) @ np.abs(K.astype(np.float64))
    assert (np.abs(xt - exact) <= 2 * run * eps * scale).all()
