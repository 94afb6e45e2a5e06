"""The dense ADMM kernel's large build (`csrc/admm_large.cu`: one block
filling an SM, the sparse QP in the split modes with a diagonal P) around
the kernel, on the CPU: the build each mode and P take, its
shared-memory planner, its lane plans (the equality and the split rows in
runs of their own) and its K^-1 parts, its summation order emulated in
numpy from the pattern block the kernel reads, and the sparse pipeline's
"mixedk6" solve through its pattern and pack, held against the JAX
package (the kernel runs only on the card, in chip_smoke.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import cache_arrays, straight_fleet, tube_arrays
from pigeon_tpu import hji as JH
from pigeon_tpu import mpc as JM
from pigeon_tpu import trajectory as JT
from pigeon_tpu.config import HorizonParams as JHP
from pigeon_tpu.config import SolverOptions as JSO
from pigeon_tpu.solver import admm as JA
from pigeon_tpu_torch import convert
from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import HorizonParams as THP
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import admm as TA
from pigeon_tpu_torch.solver import pallas_admm as TP

M_EQ = 128          # the sparse layout's leading equality rows
EPS32 = float(np.finfo(np.float32).eps)
# chip_smoke.py's sparse solver in mode "mixedk6", tiles of 2
MIXEDK6 = dict(max_iter=400, check_every=50, eps_abs=1e-3, eps_rel=1e-3,
               backend="pallas", factor_method="banded", scaling_iters=4,
               pallas_tile=2, pallas_precision="mixedk6",
               pallas_check_inner=10, bf16_bulk_iters=0)


def _cfg(hz=(5, 10), condensed=False):
    return TM.x1_coupled_config(
        hz=THP(N_short=hz[0], N_long=hz[1]), condensed=condensed,
        solver=TSO(backend="pallas"))


def _layout(hz=(5, 10), condensed=False):
    return TM._a_pattern_for(_cfg(hz, condensed))


def _large():
    return _layout().for_mode("mixedk6", M_EQ)


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


@pytest.mark.parametrize("mode", TP.MODES)
def test_plan_build_by_mode(mode):
    """The sparse layout's pattern (widths 11, 15) takes the narrow build
    in "highest" and the large one in the split modes, its rows split at
    the layout's equality rows in the mixed modes; the condensed layout's
    (39, 79) takes the wide build in every mode."""
    sparse = _layout()
    want = "narrow" if mode == "highest" else "large"
    assert TP.plan_build(sparse.row_width, sparse.col_width, mode) == want
    got = sparse.for_mode(mode, M_EQ)
    assert got.build == want
    assert got.m_split == (M_EQ if mode in TP.MIXED_MODES else 0)
    assert got.for_mode(mode, M_EQ) is got
    assert sparse.for_mode(mode, M_EQ) is got        # made once
    condensed = _layout(condensed=True)
    assert condensed.for_mode(mode, 38) is condensed
    assert condensed.build == "wide"


@pytest.mark.parametrize("mode", TP.MODES)
@pytest.mark.parametrize("hz", [(2, 3), (4, 8)], ids=str)
def test_dense_P_keeps_its_build(mode, hz):
    """A dense P never takes the large build: the condensed layout at a
    horizon whose widths are within NARROW_WIDTH_MAX (2, 3) keeps the
    narrow build in every mode, as the condensed pipeline packs it
    (`_ell_form` with its dense P), and its block fits; at (4, 8) it
    takes the wide one."""
    cfg = _cfg(hz, condensed=True)
    layout = TM._a_pattern_for(cfg)
    m_eq = int(np.asarray(TM._eq_rows_for(cfg)).size)
    want = "narrow" if hz == (2, 3) else "wide"
    assert layout.build == want
    assert TP.plan_build(layout.row_width, layout.col_width, mode,
                         dense_P=True) == want
    got = layout.for_mode(mode, m_eq, dense_P=True)
    assert got is layout
    assert TP.block_smem(got, dense_P=True, mode=mode) <= TP.SMEM_MAX


@pytest.mark.parametrize("mode", ["mixed", "mixedk6", "high", "bf16"])
def test_large_build_only_where_it_fits(mode):
    """`for_mode` gives a split mode's diagonal P the large build where
    its block fits, and else the narrow build where that fits.  At m =
    290, n = 193 and 205 (K^-1 at row stride 232; before its register
    rows left shared memory the large block was past 227 KB there) fit
    the large block.  At n = 245 it fits where 16 register rows a lane
    leave 126 rows stored; with "mixed" and "high"'s 8, 182 stay, too
    many, and so in the narrow build, which holds all of K^-1: the pair
    build.  A pattern of 3,468 rows of one nonzero at n = 109 is past 227
    KB in the large build in "mixed" (the rows' words and lanes) and
    within it in the narrow one, which it keeps."""
    rng = np.random.default_rng(0)
    for n in (193, 205, 245):
        rows = np.repeat(np.arange(290), 4)
        cols = rng.integers(0, n, rows.size)
        cols[:n] = np.arange(n)            # every column has a nonzero
        pat = TP.EllPattern(rows, cols, 290, n)
        assert pat.build == "narrow"
        got = pat.for_mode(mode, M_EQ)
        want = "large"
        if n == 245:
            assert TP.block_bytes(pat, mode=mode) > TP.SMEM_MAX
            want = "pair" if mode in ("mixed", "high") else "large"
        assert got.build == want, (n, mode)
        assert TP.block_smem(got, mode=mode) <= TP.SMEM_MAX
    assert TP.plan_build(11, 15, mode) == "large"
    n, m = 109, 3468
    tall = TP.EllPattern(np.arange(m), np.arange(m) * 7 % n, m, n)
    m_split = M_EQ if mode in TP.MIXED_MODES else 0
    large = TP.block_bytes(tall.as_build("large", m_split), mode=mode)
    assert (large > TP.SMEM_MAX) == (mode == "mixed")
    assert tall.for_mode(mode, M_EQ).build == (
        "narrow" if mode == "mixed" else "large")
    assert TP.block_smem(tall.for_mode(mode, M_EQ), mode=mode) <= TP.SMEM_MAX


@pytest.mark.parametrize("precision", ["mixedk6", "highest"])
def test_bf16_bulk_takes_its_own_build(monkeypatch, precision):
    """The sparse pipeline with a bf16 bulk (2 iterations, 2 vehicles,
    horizon (2, 3)) packs A for the bulk in the build of "bf16", the
    large one, whatever the segments' mode: in "mixedk6" it shares the
    segments' pattern and packed A, in "highest" the segments keep the
    narrow build and the bulk has a pack of its own.  `_ell_form` runs as
    on the card (on a meta copy of A; the pack itself on A), and the
    kernel calls run the plain version."""
    hz, B = (2, 3), 2
    cfg = TM.x1_coupled_config(
        hz=THP(N_short=hz[0], N_long=hz[1]),
        solver=TSO(**dict(MIXEDK6, bf16_bulk_iters=2,
                          pallas_precision=precision, max_iter=100)))
    tube = convert.tube_from_numpy(
        tube_arrays(JT.straight_trajectory(60.0, 5.0, pad_to=32)),
        device="cpu", dtype=torch.float32)
    cache = convert.cache_from_numpy(cache_arrays(JH.inactive_cache()),
                                     device="cpu")
    q0, t0 = straight_fleet(B)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    qp, warm, _ = TM._pre_solve(
        cfg, tube, cache, TM.init_carry(cfg, B, device="cpu"), f32(q0),
        f32(np.zeros((B, 3))),
        f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4))), f32(t0))
    real, calls = TA._ell_form, []

    def ell(A, *args, **kw):
        out = real(A.to("meta"), *args, **kw)
        if out is kw.get("shared"):
            return out
        return dict(out, A_packed=TP.pack(A, out["pattern"]))

    original = TP.admm_iterations

    def spy(*args, pattern=None, A_packed=None, **kw):
        calls.append((kw.get("bf16", False), pattern, A_packed))
        return original(*args, **kw)

    monkeypatch.setattr(TA, "_ell_form", ell)
    monkeypatch.setattr(TP, "admm_iterations", spy)
    TA.solve_qp_batched(qp, warm, cfg.solver,
                        banded_plan=TM._banded_plan_for(cfg),
                        eq_rows=TM._eq_rows_for(cfg),
                        a_pattern=TM._a_pattern_for(cfg))
    (bulk, b_pat, b_packed), segs = calls[0], calls[1:]
    assert bulk and segs and not any(c[0] for c in segs)
    assert b_pat.build == "large"
    s_pat, s_packed = segs[0][1], segs[0][2]
    assert all(c[1] is s_pat and c[2] is s_packed for c in segs)
    if precision == "mixedk6":
        assert s_pat is b_pat and s_packed is b_packed
        assert s_pat.m_split == int(np.asarray(TM._eq_rows_for(cfg)).size)
    else:
        assert s_pat.build == "narrow"
        assert b_packed.shape == b_pat.packed_shape(B)


def test_large_smem_planner():
    """`plan_smem_large` at the sparse QP's shapes: K^-1's stored rows at
    row stride 200 (8 parts of 26 rows, a lane's first 16 in registers:
    70 rows, 56,000 B, in place of all 193, 154,400 B, before the
    register rows left shared memory; 129 rows in "mixed" and "high",
    whose lanes keep 8) and the split modes' five vectors' words; the
    same bytes in `block_smem`; ValueError for a dense P, past n = 256
    (one K^-1 task a warp) and past 227 KB (n = 256 in "mixed": 192 rows
    at row stride 264; n = 205 fits, at 232)."""
    pat = _large()
    args = (193, 290, pat.slots, pat.lane_warps)
    assert pat.lane_warps == (10, 14) and pat.slots == (1472, 1696)
    assert TP.large_stored_rows(193, 16) == 70
    assert TP.large_stored_rows(193, 8) == 129
    assert TP.plan_smem_large(*args, mode="mixedk6") == 101424
    assert 101424 == 199824 - 4 * (193 - 70) * TP.kld(193)
    assert TP.plan_smem_large(*args) == 101424 - 4 * (3 * 193 + 2 * 290)
    assert TP.plan_smem_large(*args, mode="mixed") == 101424 + 4 * (
        129 - 70) * TP.kld(193)
    assert TP.block_smem(pat, mode="mixedk6") == 101424
    with pytest.raises(ValueError):
        TP.block_smem(pat, dense_P=True, mode="mixedk6")
    with pytest.raises(ValueError, match="n <= 256"):
        TP.plan_smem_large(257, 290, pat.slots, pat.lane_warps)
    with pytest.raises(ValueError, match="227|232448"):
        TP.plan_smem_large(256, 290, pat.slots, pat.lane_warps,
                           mode="mixed")
    assert TP.plan_smem_large(205, 290, pat.slots, pat.lane_warps,
                              mode="mixedk6") <= TP.SMEM_MAX


def _lanes(desc, runs):
    d, r = desc.astype(np.int64), runs.astype(np.int64)
    return np.stack([d & 0xFFFF, (d >> TP.LANE_G_SHIFT) & 31,
                     (d >> TP.LANE_SIZE_SHIFT) & 63, r & 0xFFFF, r >> 16,
                     (d & TP.LANE_SPLIT) != 0], axis=1)


@pytest.mark.parametrize("m_split", [M_EQ, 0, 290])
def test_lane_plans_cover_once_by_class(m_split):
    """Each row, and each column's part of equality rows (r < m_split) and
    of split rows, is one group of 1..32 contiguous lanes of one lane
    warp, its lane g = 0..G-1 in order, its class bit the part's; the
    lanes' runs read each nonzero exactly once, each run of one part; a
    lane warp holds one class; a row is never left out, an empty part of a
    column takes no lane."""
    pat = _layout().as_build("large", m_split)
    for desc, runs, pos, row_of, seg_of, rows in (
            (pat.row_lanes, pat.row_runs, pat.row_pos,
             pat.csr_flat // pat.n, pat.csr_flat // pat.n, True),
            (pat.col_lanes, pat.col_runs, pat.col_pos, pat.csc_row,
             pat.csc_flat % pat.n, False)):
        lanes = _lanes(desc, runs)
        live = lanes[:, 0] != TP.LANE_IDLE
        for w in range(lanes.shape[0] // 32):
            cls = lanes[32 * w:32 * w + 32][live[32 * w:32 * w + 32], 5]
            assert len(set(cls.tolist())) == 1
        seen = np.zeros(pat.nnz, int)
        groups = {}
        for i in np.flatnonzero(live):
            groups.setdefault((lanes[i, 0], lanes[i, 5]), []).append(i)
        for (seg, split), at in groups.items():
            at = np.array(at)
            G = lanes[at[0], 2]
            assert 1 <= G <= 32 and at.size == G
            np.testing.assert_array_equal(at, at[0] + np.arange(G))
            assert at[0] // 32 == at[-1] // 32
            np.testing.assert_array_equal(lanes[at, 1], np.arange(G))
            for lane in at:
                first, count = lanes[lane, 3:5]
                got = pos[first + 32 * np.arange(count)]
                assert (seg_of[got] == seg).all()
                np.testing.assert_array_equal(np.diff(got), 1)
                assert ((row_of[got] >= m_split) == bool(split)).all()
                seen[got] += 1
            if not rows:
                assert lanes[at, 4].sum() > 0
        assert (seen == 1).all()
        if rows:
            assert sorted({s for s, _ in groups}) == list(range(pat.m))


@pytest.mark.parametrize("n", [193, 156, 103, 70, 17, 8, 1])
def test_k_parts_cover_once(n):
    """The large build's K^-1 product: the 8 parts' runs of rows cover
    0..n-1 once, the tasks' 16 columns (4 a lane, parts 0..3 putting one
    each) cover 0..n-1 once, and at the row stride kld(n) a quarter
    warp's two parts read 16 banks apart with 16-byte aligned rows."""
    R = TP.large_k_run(n)
    rows = np.concatenate([np.arange(min(p * R, n), min(p * R + R, n))
                           for p in range(TP.LARGE_K_PARTS)])
    np.testing.assert_array_equal(rows, np.arange(n))
    tasks = -(-n // TP.LARGE_K_TASK)
    cols = [t * TP.LARGE_K_TASK + cl * TP.LARGE_K_COLS + p
            for t in range(tasks)
            for cl in range(32 // TP.LARGE_K_PARTS) for p in range(4)]
    cols = [c for c in cols if c < n]
    assert sorted(cols) == list(range(n)) and len(set(cols)) == n
    assert TP.kld(n) % 32 == 8
    # the parts of a quarter warp (8 lanes) start 32 / parts banks apart
    quarter = 8 * TP.LARGE_K_PARTS // 32
    assert sorted(p * R * TP.kld(n) % 32 for p in range(quarter)) == list(
        range(0, 32, 32 // quarter))


def _split(a):
    """bf16 (hi, lo) of float32 values, float32 (round to nearest even)."""
    t = torch.as_tensor(np.asarray(a, np.float32))
    hi = t.to(torch.bfloat16).to(torch.float32)
    return hi.numpy(), (t - hi).to(torch.bfloat16).to(torch.float32).numpy()


def _large_products(desc, runs, vals, idx, v, n_out, rows):
    """The large build's A products in float32 in mode "mixedk6" (multiply,
    then add): a split lane sums its three sums of the bf16 pairs in
    order, an equality lane its v in order (in a row, in two interleaved
    partial sums added at the end); each group's tree adds lane g + d's sums to lane g's for d =
    1, 2, 4, ...; a row is its class's sum, a column the sum of its
    equality part's and of its split part's ((hh + hl) + lh)."""
    f = np.float32
    parts = np.zeros((n_out, 2), np.float32)
    lanes = _lanes(desc, runs)
    v_hi, v_lo = _split(v)
    for w in range(lanes.shape[0] // 32):
        ln = lanes[32 * w:32 * w + 32]
        sums = np.zeros((32, 4), np.float32)       # acc, hh, hl, lh
        for lane, (_, _, _, first, count, split) in enumerate(ln):
            slots = first + 32 * np.arange(count)
            if split:
                for slot in slots:
                    r = idx[slot]
                    m_hi, m_lo = _split(vals[slot])
                    terms = (0.0, v_hi[r] * m_hi, v_hi[r] * m_lo,
                             v_lo[r] * m_hi)
                    sums[lane] = (sums[lane] + np.asarray(terms, f)).astype(f)
                continue
            part = np.zeros(2, f)
            for i, slot in enumerate(slots):
                k = i % 2 if rows else 0
                part[k] = f(part[k] + f(vals[slot] * v[idx[slot]]))
            sums[lane, 0] = f(part[0] + part[1])
        d = 1
        while d < ln[:, 2].max():
            shifted = np.concatenate([sums[d:], sums[32 - d:]])
            add = ((ln[:, 1] & (2 * d - 1)) == 0) & (ln[:, 1] + d < ln[:, 2])
            sums = np.where(add[:, None], (sums + shifted).astype(f), sums)
            d *= 2
        for lane, (seg, g, _, _, _, split) in enumerate(ln):
            if seg != TP.LANE_IDLE and g == 0:
                a, hh, hl, lh = sums[lane]
                parts[seg, int(split)] = f(f(hh + hl) + lh) if split else a
    if rows:
        return parts.sum(axis=1).astype(np.float64)   # one part is 0
    return f(parts[:, 0] + parts[:, 1]).astype(np.float64)


def test_large_products_in_their_order():
    """A'w, A x (mode "mixedk6": the 128 equality rows fp32, a row lane's
    run in two interleaved partial sums, the split rows' three sums of bf16
    pairs) and rhs' K^-1 (fp32, 8 parts of
    `large_k_run` rows added in the xor butterfly), summed as the large
    build sums them, decoded from its pattern block and packed values, on
    the sparse layout's A.  Each lies within float32 rounding of the same
    products at float64 (`pallas_admm.products(..., "mixedk6")`, which
    keeps the bf16 roundings), and of the exact float64 products within
    that plus the split's truncation (2^-15 of a term) on the split rows."""
    pat = _large()
    rng = np.random.default_rng(3)
    rows, cols = pat.csr_flat // pat.n, pat.csr_flat % pat.n
    A = np.zeros((pat.m, pat.n), np.float32)
    A[rows, cols] = rng.normal(size=pat.nnz) * np.exp(
        rng.uniform(-3, 3, pat.nnz))
    At = torch.as_tensor(A)[None]
    vals = TP.pack(At, pat)[0].numpy()
    sr = pat.slots[0]
    x = rng.normal(size=pat.n).astype(np.float32)
    w = rng.normal(size=pat.m).astype(np.float32)
    (rl, rr, ridx), (cl, cr, cidx) = _decode(pat)
    ax = _large_products(rl, rr, vals[:sr], ridx, x, pat.m, rows=True)
    atw = _large_products(cl, cr, vals[sr:], cidx, w, pat.n, rows=False)
    n = pat.n
    K = rng.normal(size=(n, n)).astype(np.float32)
    matA, matAT, matK = TP.products(
        torch.as_tensor(K, dtype=torch.float64)[None],
        At.double(), "mixedk6", M_EQ)
    A64, absA = A.astype(np.float64), np.abs(A.astype(np.float64))
    split = np.arange(pat.m) >= M_EQ
    cut = 2.0 ** -15
    for got, mode_ref, exact, scale, split_scale, length in (
            (ax, matAT(torch.as_tensor(x, dtype=torch.float64)[None])[0],
             A64 @ x, absA @ np.abs(x),
             np.where(split, absA @ np.abs(x), 0.0), pat.row_width),
            (atw, matA(torch.as_tensor(w, dtype=torch.float64)[None])[0],
             A64.T @ w, absA.T @ np.abs(w),
             (absA * split[:, None]).T @ np.abs(w), pat.col_width)):
        bar = 2 * (length + 5) * EPS32 * scale
        assert (np.abs(got - mode_ref.numpy()) <= bar).all()
        assert (np.abs(got - exact) <= bar + cut * split_scale).all()
    # rhs' K^-1: part p sums rows [p R, p R + R) ascending, then
    # ((s0 + s1) + (s2 + s3)) + ((s4 + s5) + (s6 + s7))
    R = TP.large_k_run(n)
    parts = np.zeros((8, n), np.float32)
    for p in range(8):
        for j in range(min(p * R, n), min(p * R + R, n)):
            parts[p] = (parts[p] + (x[j] * K[j]).astype(np.float32)).astype(
                np.float32)
    add = lambda a, b: (a + b).astype(np.float32)
    xt = add(add(add(parts[0], parts[1]), add(parts[2], parts[3])),
             add(add(parts[4], parts[5]), add(parts[6], parts[7])))
    ref = matK(torch.as_tensor(x, dtype=torch.float64)[None])[0].numpy()
    scale = np.abs(x.astype(np.float64)) @ np.abs(K.astype(np.float64))
    assert (np.abs(xt - ref) <= 2 * (R + 3) * EPS32 * scale).all()


def _scatter(packed, pat):
    """A back from each half of the large build's packed values (row
    slots, column slots)."""
    B = packed.shape[0]
    sr = pat.slots[0]
    out = []
    for half, pos, flat in ((packed[:, :sr], pat.row_pos, pat.csr_flat),
                            (packed[:, sr:], pat.col_pos, pat.csc_flat)):
        back = torch.zeros((B, pat.m * pat.n), dtype=packed.dtype)
        keep = torch.as_tensor(pos >= 0)
        back[:, torch.as_tensor(flat[pos[pos >= 0]])] = half[:, keep]
        out.append(back.view(B, pat.m, pat.n))
    return out


def test_mixedk6_pipeline_through_the_large_pack(monkeypatch):
    """The sparse pipeline's "mixedk6" solve (3 vehicles, horizon (2, 3),
    float32) with every dense ADMM call made on the A that the large
    build's pattern and pack carry: the pipeline's pattern is the large
    build's, split at the layout's equality rows; its pack scattered back
    from either slot order is A exactly; and the solution, the plain
    version on that A, is the JAX pipeline's (interpret mode) by the rule
    of tests/test_torch_mpc_sparse.py, with statistics within
    tests/test_batched_step.py's 5e-5 of the residuals recomputed from
    it."""
    hz, B = (2, 3), 3
    jcfg = JM.x1_coupled_config(hz=JHP(N_short=hz[0], N_long=hz[1]),
                                solver=JSO(**MIXEDK6))
    tcfg = TM.x1_coupled_config(hz=THP(N_short=hz[0], N_long=hz[1]),
                                solver=TSO(**MIXEDK6))
    jtube = JT.straight_trajectory(60.0, 5.0, pad_to=32)
    ttube = convert.tube_from_numpy(tube_arrays(jtube), device="cpu",
                                    dtype=torch.float32)
    tcache = convert.cache_from_numpy(cache_arrays(JH.inactive_cache()),
                                      device="cpu")
    q0, t0 = straight_fleet(B)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    carry = TM.init_carry(tcfg, B, device="cpu")
    oc = f32(np.broadcast_to([1e4, 1e4, 0.0, 0.0], (B, 4)))
    qp, warm, _ = TM._pre_solve(tcfg, ttube, tcache, carry, f32(q0),
                                f32(np.zeros((B, 3))), oc, f32(t0))
    eq_rows = TM._eq_rows_for(tcfg)
    m_eq = int(np.asarray(eq_rows).size)
    layout = TM._a_pattern_for(tcfg)
    assert layout.build == "narrow"

    # the card's forms of A on the CPU: the pipeline's _ell_form as it is
    # on a CUDA tensor, and each call's A rebuilt from the pack
    def ell(A, a_pattern=None, mode="highest", m_eq_=0, dense_P=False,
            shared=None):
        pattern = a_pattern.for_mode(mode, m_eq_, dense_P)
        return dict(pattern=pattern, A_packed=TP.pack(A, pattern))

    calls, original = [], TP.admm_iterations

    def spy(Kinv, A, *args, pattern=None, A_packed=None, **kw):
        rows, cols = _scatter(A_packed, pattern)
        calls.append((pattern, kw.get("m_eq"), torch.equal(rows, A)
                      and torch.equal(cols, A)))
        return original(Kinv, rows, *args, **kw)

    monkeypatch.setattr(TA, "_ell_form", ell)
    monkeypatch.setattr(TP, "admm_iterations", spy)
    tsol = TA.solve_qp_batched(qp, warm, tcfg.solver,
                               banded_plan=TM._banded_plan_for(tcfg),
                               eq_rows=eq_rows, a_pattern=layout)
    assert calls and all(p.build == "large" and p.m_split == m_eq == me
                         and exact for p, me, exact in calls)
    J = lambda tup: [jnp.asarray(x.numpy()) for x in tup]
    jsol = JA.solve_qp_batched(
        JA.QPData(*J(qp)), JA.QPWarmStart(*J(warm)), jcfg.solver,
        banded_plan=JM._banded_plan_for(jcfg), eq_rows=JM._eq_rows_for(jcfg))
    np.testing.assert_array_equal(tsol.converged.numpy(),
                                  np.asarray(jsol.converged))
    assert bool(tsol.converged.all())
    assert np.abs(tsol.iterations.numpy()
                  - np.asarray(jsol.iterations)).max() <= 50
    d64 = lambda tup: type(tup)(*[x.double() for x in tup])
    exact = TA.solve_qp_batched(
        d64(qp), d64(TA.cold_start(qp)),
        dataclasses.replace(tcfg.solver, backend="xla"),
        banded_plan=TM._banded_plan_for(tcfg))
    for name in ("x", "z", "y"):
        e = getattr(exact, name).numpy()
        d_port = np.abs(getattr(tsol, name).numpy() - e).max()
        d_jax = np.abs(np.asarray(getattr(jsol, name)) - e).max()
        assert d_port <= 3.0 * d_jax + 1e-4 * np.abs(e).max(), (
            name, d_port, d_jax)
    A, P, q = (qp.A.double().numpy(), qp.P_diag.double().numpy(),
               qp.q.double().numpy())
    x, z, y = (tsol.x.double().numpy(), tsol.z.double().numpy(),
               tsol.y.double().numpy())
    for b in range(B):
        rp = np.abs(A[b] @ x[b] - z[b]).max()
        rd = np.abs(P[b] * x[b] + q[b] + A[b].T @ y[b]).max()
        np.testing.assert_allclose(float(tsol.prim_res[b]), rp, rtol=1e-2,
                                   atol=5e-5)
        np.testing.assert_allclose(float(tsol.dual_res[b]), rd, rtol=1e-2,
                                   atol=5e-5)
