"""Dense-K^-1 ADMM iterations on a CUDA kernel (counterpart of
`pigeon_tpu/solver/pallas_admm.py`, all five precision modes, with a
diagonal P, the sparse QP's, or a dense one, the condensed QP's).

`admm_iterations` launches `csrc/admm_dense.cu` for CUDA tensors and runs
its plain PyTorch version, `admm_iterations_plain` (same iteration, same
statistics, same early exit per tile), for CPU tensors.  Both compute in
the inputs' dtype; the solver passes float32, as the JAX package's kernel
computes.  The modes change the arithmetic of the products v M:
"highest" plain sums; "bf16" M and v rounded to bfloat16; "high" the
bf16 split v M ~ (v_hi M_hi + v_hi M_lo) + v_lo M_hi of every product;
"mixed" and "mixedk6" the split for the inequality rows of A (after the
`m_eq` equality rows, which stay plain), and for K^-1 in "mixed".

The kernel holds each instance's K^-1 and the nonzeros of its A in one
block's shared memory.  `EllPattern` is A's static nonzero pattern (shared
by every instance; the layout gives it, see `layout_pattern`) and `pack`
gathers an A's values into it.  It has three builds, picked from the
pattern's widths and the mode by `plan_build`: the narrow one
(`csrc/admm_dense.cu`, A in an ELL form, the sparse QP in "highest"), the
wide one (`csrc/admm_wide.cu`, A compact in row and column order, the
condensed QP's long rows and columns split over lanes by `lane_plan`) and
the large one (`csrc/admm_large.cu`: the wide build's compact A, one block
of LARGE_WARPS warps filling an SM, the sparse QP in the split modes with
a diagonal P; `class_lane_plan`).  Where the planned build's block does
not fit, `EllPattern.for_mode` gives a diagonal P the narrow build, else
the large one, where its block fits: the large build keeps each K^-1
lane's first `large_kreg(mode)` rows in registers and stores only the
others (`large_stored_rows`), which lets it hold the sparse decoupled
QP's K^-1 (n = 245) in "highest", "mixedk6" and "bf16".  A diagonal P
whose block fits none of them (n > LARGE_N_MAX, or n = 245 in "mixed"
and "high") takes the large build's pair form (kernel "admm_pair" of the
same source): an instance on two blocks, each holding half of K^-1's
columns.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from pigeon_tpu_torch import _kernels
from pigeon_tpu_torch.solver.admm import _mtv, _mv

# the kernel's limits: the tile is a cluster of `tile` blocks (the portable
# cluster size), a block may use 227 KB of shared memory, and row-ELL
# slots are 16-bit
TILE_MAX = 8
SMEM_MAX = 232448
SLOTS_MAX = 32767


# the precision modes, in the order of csrc/admm_dense.cu's MODE
MODES = ("highest", "mixed", "mixedk6", "high", "bf16")
MIXED_MODES = ("mixed", "mixedk6")

# a row slot's code (csrc/admm_dense.cu): column, merges after the slot,
# first and last slot of its lane's sum
CODE_MERGE_SHIFT, CODE_FIRST, CODE_LAST = 16, 1 << 19, 1 << 20

# The narrow build gives each row of A, and each column, one thread: a
# dependent chain as long as the row or column.  A pattern with a row or
# column longer than a warp's 32 lanes takes the wide build, which splits
# them over lanes (the condensed QP's widths 39 and 79; the sparse QP's 11
# and 15 keep the narrow build and its first design's sums).
NARROW_WIDTH_MAX = 32
# the builds with the large build's forms of A (compact, class lane plans)
LARGE_FORMS = ("large", "pair")
# the wide build's warps a block, and a lane descriptor of its lane plans
# (csrc/admm_wide.cu): segment, place in the group, group size, and (the
# large build's) whether the lane's run is of split rows
WIDE_WARPS = 10
LANE_IDLE, LANE_G_SHIFT, LANE_SIZE_SHIFT = 0xFFFF, 16, 21
LANE_SPLIT = 1 << 27
# the large build's warps a block (csrc/admm_large.cu's L_THREADS / 32),
# and its K^-1 product: 8 parts of a column's rows, 16 columns a warp, 4 a
# lane
LARGE_WARPS = 16
LARGE_K_PARTS, LARGE_K_TASK, LARGE_K_COLS = 8, 16, 4
# the large build's n: one K^-1 task a warp (csrc/admm_large.cu's L_N_MAX)
LARGE_N_MAX = LARGE_WARPS * LARGE_K_TASK
# the pair build's tile is a cluster of 2 tile blocks
PAIR_TILE_MAX = TILE_MAX // 2


def plan_build(row_width: int, col_width: int, mode: str = "highest",
               dense_P: bool = False) -> str:
    """The dense ADMM kernel's build for a pattern of these widths in
    `mode`: "wide" past NARROW_WIDTH_MAX; within it "large" for a
    diagonal P in the split modes ("mixed", "mixedk6", "high", "bf16"),
    else "narrow".  `EllPattern.for_mode` then takes, for a diagonal P
    whose block does not fit, the narrow build, else the large one, where
    its block fits, and else the "pair" build."""
    if max(row_width, col_width) > NARROW_WIDTH_MAX:
        return "wide"
    return "narrow" if mode == "highest" or dense_P else "large"


def kld(n: int) -> int:
    """The wide build's row stride of K^-1: n rounded
    up to 8 mod 32, so a warp's 8 columns by 4 rows hit 32 banks."""
    return n + (8 - n) % 32


def large_k_run(n: int) -> int:
    """The large build's rows of a K^-1 part (csrc/admm_large.cu's
    `lk_run`): ceil(n / 8) rounded up to 2 mod 4, so that at the row
    stride `kld(n)` (8 mod 32) a quarter warp's two parts read 16 banks
    apart."""
    r = -(-n // LARGE_K_PARTS)
    return r + (2 - r) % 4


def large_kreg(mode: str) -> int:
    """The rows of its part of K^-1 a K^-1 lane of the large build keeps
    in registers (csrc/admm_large.cu's `kreg_of`): 8 where the K^-1 words
    are split ("mixed", "high"), else 16."""
    return 8 if mode in ("mixed", "high") else 16


def large_stored_rows(n: int, kreg: int) -> int:
    """The rows of K^-1 the large build stores in shared memory
    (csrc/admm_large.cu's `stored_rows`): each part's rows past its first
    `kreg`, the register rows."""
    run = large_k_run(n)
    return sum(max(min(run, n - p * run) - kreg, 0)
               for p in range(LARGE_K_PARTS))


def pair_cols0(n: int) -> int:
    """The pair build's K^-1 columns in block 0 of a pair
    (csrc/admm_large.cu's `pair_cols0`): half of the product's
    LARGE_K_TASK-column tasks, rounded up; block 1 takes the rest."""
    tasks = -(-n // LARGE_K_TASK)
    return (tasks + 1) // 2 * LARGE_K_TASK


def pair_ld(n: int) -> int:
    """The pair build's row stride of a block's K^-1 columns: `pair_cols0`
    rounded up to 8 mod 32, as `kld`."""
    return kld(pair_cols0(n))


def _pack_groups(size, segs=None) -> list:
    """Groups of `size[s]` contiguous lanes (of the segments `segs`, all
    if None) into 32-lane warps, first fit by decreasing size (ties by
    segment): a list of each warp's segments."""
    segs = np.arange(size.size) if segs is None else np.asarray(segs)
    warps, room = [], []
    for seg in segs[np.lexsort((segs, -size[segs]))]:
        g = int(size[seg])
        for w, r in enumerate(room):
            if r >= g:
                warps[w].append(seg)
                room[w] -= g
                break
        else:
            warps.append([seg])
            room.append(32 - g)
    return warps


def lane_plan(lengths, warps: int = WIDE_WARPS) -> np.ndarray:
    """The wide build's lanes for segments (rows or columns of A) of these
    lengths: each segment a group of G = ceil(len / L) lanes (1..32) in
    one lane warp, for the chain length L whose plan has the least
    estimated latency (then the fewest lane warps): the block's `warps`
    run the lane warps in rounds, and a round costs ~32 FMA latencies of
    dependent shared loads and stores (a lane's descriptor and run, an
    index, the vector's entry, the result; ~8 each), L FMAs and the group
    tree's log2 G steps (~8 each).  Returns one int32 descriptor a lane, 32 a
    lane warp: segment | g << LANE_G_SHIFT | G << LANE_SIZE_SHIFT, idle
    lanes LANE_IDLE with G 1."""
    lengths = np.asarray(lengths, np.int64)
    longest = max(1, int(lengths.max(initial=0)))
    best, packs = None, {}
    for L in range(-(-longest // 32), longest + 1):
        size = np.clip(-(-lengths // L), 1, 32)
        key = size.tobytes()
        if key not in packs:
            packs[key] = _pack_groups(size)
        packed = packs[key]
        steps = int(np.ceil(np.log2(size.max())))
        cost = (-(-len(packed) // warps) * (32 + L + 8 * steps),
                len(packed))
        if best is None or cost < best[0]:
            best = cost, size, packed
    _, size, packed = best
    desc = np.full((len(packed), 32), LANE_IDLE | (1 << LANE_SIZE_SHIFT),
                   np.int64)
    for w, segs in enumerate(packed):
        lane = 0
        for seg in segs:
            g = int(size[seg])
            desc[w, lane:lane + g] = (seg | (np.arange(g) << LANE_G_SHIFT)
                                      | (g << LANE_SIZE_SHIFT))
            lane += g
    return desc.reshape(-1).astype(np.int32)


def _bitrev5(v):
    return sum(((v >> b) & 1) << (4 - b) for b in range(5))


def _merges(keys) -> list:
    """The merges after each leaf when the leaves at `keys` (ascending, in
    0..31) are added in the balanced binary tree over 0..31 with the
    absent leaves left out, as a stack evaluates it in post-order."""
    def post(lo, size):
        inside = [k for k in keys if lo <= k < lo + size]
        if not inside:
            return []
        if size == 1:
            return ["leaf"]
        left, right = post(lo, size // 2), post(lo + size // 2, size // 2)
        return left + right + ["merge"] if left and right else left or right
    out = []
    for t in post(0, 32):
        if t == "leaf":
            out.append(0)
        else:
            out[-1] += 1
    return out


def _slots(first, count) -> tuple:
    """The slots of lane runs (csrc/admm_wide.cu): lane l of lane warp w
    reads `count[l]` consecutive positions from `first[l]` at slots base_w
    + l, + 32, ..., base_w the slots of the lane warps before w, 32 times
    the longest run of each.  Returns each lane's run word (its first slot
    | its count << 16) and the position read at each slot (-1 for a pad,
    never read)."""
    longest = count.reshape(-1, 32).max(axis=1)
    base = np.concatenate([[0], np.cumsum(32 * longest)[:-1]])
    slot0 = np.repeat(base, 32) + np.arange(count.size) % 32
    pos = np.full(32 * int(longest.sum()), -1, np.int64)
    lane = np.repeat(np.arange(count.size), count)
    i = np.arange(lane.size) - np.repeat(np.cumsum(count) - count, count)
    pos[slot0[lane] + 32 * i] = first[lane] + i
    if pos.size > SLOTS_MAX:
        raise ValueError(f"{pos.size} slots exceed the wide build's 16-bit "
                         f"slots")
    return (slot0 | (count << 16)).astype(np.int32), pos


def _slices(desc, starts) -> tuple:
    """`_slots` of a lane plan: lane g of a segment's group of G reads
    its g-th run of ceil(len / G) consecutive positions (from the segment
    starts `starts`; none for an idle lane)."""
    desc = desc.astype(np.int64)
    seg = desc & 0xFFFF
    idle = seg == LANE_IDLE
    seg = np.where(idle, 0, seg)
    g, size = (desc >> LANE_G_SHIFT) & 31, (desc >> LANE_SIZE_SHIFT) & 63
    s0, s1 = starts[seg].astype(np.int64), starts[seg + 1].astype(np.int64)
    run = -(-(s1 - s0) // size)
    p = np.minimum(s0 + g * run, s1)
    count = np.where(idle, 0, np.minimum(p + run, s1) - p)
    return _slots(p, count)


def class_lane_plan(eq_lengths, split_lengths, starts,
                    warps: int = LARGE_WARPS, parts: bool = False) -> tuple:
    """The large build's lanes for segments (rows or columns of A) whose
    first `eq_lengths` positions (from `starts[seg]`) are of equality rows
    and the next `split_lengths` of split rows: G_e = ceil(le / L) lanes on
    runs of a segment's equality part and G_s = ceil(ls / L) (class bit
    LANE_SPLIT) on runs of its split part, so that no run mixes the two,
    L, the chain length, as `lane_plan` picks it for groups of G_e + G_s
    lanes.  The groups are packed into lane warps of one class each: a
    segment of one class (a row) is one group; with `parts` (the columns)
    each part with positions is a group of its own (an empty part takes
    no lane), both named by the segment.  Returns the descriptors (int32,
    32 a lane warp) and each lane's first position and count."""
    le = np.asarray(eq_lengths, np.int64)
    ls = np.asarray(split_lengths, np.int64)
    longest = max(1, int(max(le.max(initial=0), ls.max(initial=0))))
    best = None
    for L in range(1, longest + 1):
        ge, gs = -(-le // L), -(-ls // L)
        size = np.maximum(ge + gs, 1)
        if size.max() > 32:
            continue
        packed = _pack_groups(size)
        steps = int(np.ceil(np.log2(size.max())))
        cost = (-(-len(packed) // warps) * (32 + L + 8 * steps), len(packed))
        if best is None or cost < best[0]:
            best = cost, ge, gs
    _, ge, gs = best
    S = le.size
    if parts:
        # group k < S: segment k's equality part; S + k: its split part
        size = np.concatenate([ge, gs])
        seg_of, split = np.tile(np.arange(S), 2), np.repeat([0, 1], S)
        s0 = np.concatenate([starts[:S], starts[:S] + le])
        length = np.concatenate([le, ls])
        groups = np.flatnonzero(size > 0)
    else:
        size = np.maximum(ge + gs, 1)
        seg_of, split = np.arange(S), ((le == 0) & (ls > 0)).astype(np.int64)
        s0, length = starts[:S] + np.where(split, le, 0), le + ls
        groups = np.arange(S)
    packed = (_pack_groups(size, groups[split[groups] == 0])
              + _pack_groups(size, groups[split[groups] == 1]))
    idle = LANE_IDLE | (1 << LANE_SIZE_SHIFT)
    desc = np.full((len(packed), 32), idle, np.int64)
    first = np.zeros((len(packed), 32), np.int64)
    count = np.zeros((len(packed), 32), np.int64)
    for w, grps in enumerate(packed):
        lane = 0
        for k in grps:
            G = int(size[k])
            g = np.arange(G)
            desc[w, lane:lane + G] = (seg_of[k] | (g << LANE_G_SHIFT)
                                      | (G << LANE_SIZE_SHIFT)
                                      | split[k] * LANE_SPLIT)
            run = -(-length[k] // G)
            p = np.minimum(s0[k] + g * run, s0[k] + length[k])
            first[w, lane:lane + G] = p
            count[w, lane:lane + G] = np.minimum(p + run,
                                                 s0[k] + length[k]) - p
            lane += G
    return (desc.reshape(-1).astype(np.int32), first.reshape(-1),
            count.reshape(-1))


class EllPattern:
    """The nonzero positions (rows, cols) of an m x n matrix in the forms
    of the kernel's build (numpy; `tensors` moves them to a device):
    `build` ("narrow" or "wide"; `plan_build` of the widths unless
    given), `nnz`, and `row_width`, `col_width` the most nonzeros of a row
    and of a column.

    The narrow build's:

    - row-ELL: each row's `row_width` slots; `flat` the index r n + c of
      each slot in the flattened A (pads point at entry 0 and are never
      read); `row_code` (m, row_width) int32, -1 pads: the column, and
      what the kernel's thread per row does after the slot.  The first
      design summed a row with a warp, lane l over columns j = l, l + 32,
      ... and then the lanes' sums in the xor butterfly, a balanced tree
      over the lanes in bit-reversed order; so the slots are in
      (bit-reversed col % 32, col) order, CODE_FIRST and CODE_LAST mark a
      lane's first and last slot, and the bits from CODE_MERGE_SHIFT count
      the tree's merges after that lane's sum (the absent lanes' zero
      sums left out);
    - column-ELL: each column's row-ELL slots in ascending row, `col_slot`
      and `col_row` (n, col_width) int16, -1 pads.

    The wide build's: each nonzero once in row order and once in column
    order, `csr_flat` and `csc_flat` the index r n + c of each in the
    flattened A, `csr_col` and `csc_row` its column and row,
    `csr_start` (m + 1) and `csc_start` (n + 1) each row's and column's
    first; the rows' and the columns' `lane_plan`s (`row_lanes`,
    `col_lanes`), each lane's run word (`row_runs`, `col_runs`) and the
    position in row (column) order each slot reads (`row_pos`, `col_pos`,
    -1 pads; `_slices`); and `plan`, the lane plans, the runs and each
    slot's column (row) in one int32 block, as the kernel copies it
    (csrc/admm_wide.cu's `plan_words`).

    The large build's: the wide build's forms, its lane plans from
    `class_lane_plan` with the rows before `m_split` (the mixed modes'
    equality rows; 0 for the other modes) apart from the others, so that
    no lane's run mixes the two.  The pair build ("pair") takes the large
    build's forms."""

    def __init__(self, rows, cols, m: int, n: int, build: str = None,
                 m_split: int = 0):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        key = np.unique(rows * n + cols)
        rows, cols = key // n, key % n
        self.m, self.n, self.nnz = m, n, key.size
        self._key = key
        per_row = np.bincount(rows, minlength=m)
        per_col = np.bincount(cols, minlength=n)
        self.row_width = max(1, int(per_row.max(initial=0)))
        self.col_width = max(1, int(per_col.max(initial=0)))
        self.build = build or plan_build(self.row_width, self.col_width)
        self.m_split = int(m_split) if self.build in LARGE_FORMS else 0
        self._on = {}
        self._forms = {}
        if self.build in ("wide",) + LARGE_FORMS:
            self._compact(rows, cols, per_row, per_col)
        elif self.build == "narrow":
            self._narrow(rows, cols)
        else:
            raise ValueError(f"unknown build {build!r}")

    def _compact(self, rows, cols, per_row, per_col):
        if max(self.nnz, self.m, self.n) > SLOTS_MAX:
            raise ValueError(f"{self.nnz} nonzeros of a {self.m} x "
                             f"{self.n} matrix exceed the wide build's "
                             f"16-bit positions")
        if not 0 <= self.m_split <= self.m:
            raise ValueError(f"m_split={self.m_split} outside 0..{self.m}")
        starts = lambda per: np.concatenate([[0], np.cumsum(per)])
        self.csr_flat = self._key
        self.csr_col = cols
        self.csr_start = starts(per_row)
        by_col = np.lexsort((rows, cols))
        self.csc_flat = self._key[by_col]
        self.csc_row = rows[by_col]
        self.csc_start = starts(per_col)
        if self.build == "wide":
            self.row_lanes = lane_plan(per_row)
            self.col_lanes = lane_plan(per_col)
            self.row_runs, self.row_pos = _slices(self.row_lanes,
                                                  self.csr_start)
            self.col_runs, self.col_pos = _slices(self.col_lanes,
                                                  self.csc_start)
        else:
            # the rows, each of one class; the columns, each a group for
            # its part of equality rows (first in its ascending rows) and
            # one for its part of split rows
            eq_row = np.arange(self.m) < self.m_split
            per_col_eq = np.bincount(cols[rows < self.m_split],
                                     minlength=self.n)
            for name, le, ls, start in (
                    ("row", np.where(eq_row, per_row, 0),
                     np.where(eq_row, 0, per_row), self.csr_start),
                    ("col", per_col_eq, per_col - per_col_eq,
                     self.csc_start)):
                lanes, first, count = class_lane_plan(
                    le, ls, start, parts=name == "col")
                runs, pos = _slots(first, count)
                setattr(self, f"{name}_lanes", lanes)
                setattr(self, f"{name}_runs", runs)
                setattr(self, f"{name}_pos", pos)
        # a pad slot reads entry 0 of A and of the vector, and is never read
        at = lambda a, pos: np.where(pos >= 0, a[np.maximum(pos, 0)], 0)
        even = lambda a: np.concatenate([a, np.zeros(a.size % 2, a.dtype)])
        shorts = np.concatenate([even(at(self.csr_col, self.row_pos)),
                                 even(at(self.csc_row, self.col_pos))])
        shorts = shorts.astype(np.int16)
        self.plan = np.concatenate([self.row_lanes, self.row_runs,
                                    self.col_lanes, self.col_runs,
                                    shorts.view(np.int32)])
        self._slot_flat = np.concatenate([at(self.csr_flat, self.row_pos),
                                          at(self.csc_flat, self.col_pos)])

    def _narrow(self, rows, cols):
        m, n = self.m, self.n
        if n > 1 << CODE_MERGE_SHIFT:
            raise ValueError(f"n={n} exceeds the kernel's 16-bit columns")
        lane_key = _bitrev5(cols % 32)
        order = np.lexsort((cols, lane_key, rows))
        rows, cols, lane_key = rows[order], cols[order], lane_key[order]
        per_row = np.bincount(rows, minlength=m)
        start = np.concatenate([[0], np.cumsum(per_row)[:-1]])
        pos = np.arange(rows.size) - start[rows]
        slot = rows * self.row_width + pos
        if m * self.row_width > SLOTS_MAX:
            raise ValueError(f"{m} rows of {self.row_width} slots exceed the "
                             f"kernel's {SLOTS_MAX} 16-bit slot indices")
        self.flat = np.zeros(m * self.row_width, np.int64)
        self.flat[slot] = rows * n + cols
        code = cols.copy()
        for r in range(m):
            at = np.flatnonzero(rows == r)
            if at.size == 0:
                continue
            keys = lane_key[at]
            first = np.r_[True, keys[1:] != keys[:-1]]
            last = np.r_[keys[1:] != keys[:-1], True]
            merges = np.zeros(at.size, np.int64)
            merges[last] = _merges(list(keys[last]))
            code[at] |= (first * CODE_FIRST + last * CODE_LAST
                         + (merges << CODE_MERGE_SHIFT))
        self.row_code = np.full((m, self.row_width), -1, np.int32)
        self.row_code[rows, pos] = code
        by_col = np.lexsort((rows, cols))
        per_col = np.bincount(cols, minlength=n)
        cstart = np.concatenate([[0], np.cumsum(per_col)[:-1]])
        cpos = np.arange(cols.size) - cstart[cols[by_col]]
        self.col_slot = np.full((n, self.col_width), -1, np.int16)
        self.col_row = np.full((n, self.col_width), -1, np.int16)
        self.col_slot[cols[by_col], cpos] = slot[by_col]
        self.col_row[cols[by_col], cpos] = rows[by_col]

    def as_build(self, build: str, m_split: int = 0) -> "EllPattern":
        """The same positions in the forms of `build` (the large and pair
        builds' rows split at `m_split`), made once per pattern."""
        key = (build, int(m_split) if build in LARGE_FORMS else 0)
        if key not in self._forms:
            self._forms[key] = EllPattern(self._key // self.n,
                                          self._key % self.n, self.m,
                                          self.n, *key)
        return self._forms[key]

    def _split_form(self, build: str, mode: str, m_eq: int):
        """The pattern in the large or pair build, its rows split at the
        mixed modes' `m_eq`: itself if it is that form already (a pattern
        split anywhere serves the other modes, which read no row's
        class)."""
        mixed = mode in MIXED_MODES
        if self.build == build and (not mixed or self.m_split == m_eq):
            return self
        return self.as_build(build, m_eq if mixed else 0)

    def for_mode(self, mode: str, m_eq: int = 0,
                 dense_P: bool = False) -> "EllPattern":
        """The pattern in the build `plan_build` gives its widths, `mode`
        and `dense_P` (the large and pair builds' rows split at the mixed
        modes' `m_eq`); for a diagonal P whose block does not fit there,
        the narrow build, else the large one, where its block fits
        (`block_smem`), and else the pair build: itself if it is that
        form already."""
        build = plan_build(self.row_width, self.col_width, mode, dense_P)
        order = ((build,) if dense_P or build == "wide"
                 else dict.fromkeys((build, "narrow", "large")))
        for b in order:
            form = (self._split_form(b, mode, m_eq) if b in LARGE_FORMS
                    else self if b == self.build else self.as_build(b))
            if dense_P or _fits(form, mode):
                return form
        return self._split_form("pair", mode, m_eq)

    @property
    def lane_warps(self) -> tuple:
        """The wide (and large, pair) build's lane warps: (rows,
        columns)."""
        return self.row_lanes.size // 32, self.col_lanes.size // 32

    @property
    def slots(self) -> tuple:
        """The wide (and large, pair) build's slots: (rows, columns)."""
        return self.row_pos.size, self.col_pos.size

    def packed_shape(self, B: int) -> tuple:
        """The shape of `pack`'s values for B instances: the row-ELL's (B,
        m, row_width), or the wide, large and pair builds' (B, row slots +
        column slots)."""
        return ((B, self.m, self.row_width) if self.build == "narrow"
                else (B, sum(self.slots)))

    def tensors(self, device) -> dict:
        """The pattern's arrays on `device` (cached per device): `flat`,
        the gather `pack` makes, and the build's arrays the kernel reads."""
        key = str(torch.device(device))
        if key not in self._on:
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                          device=device)
            if self.build == "narrow":
                self._on[key] = dict(
                    flat=t(self.flat), row_code=t(self.row_code),
                    col_slot=t(self.col_slot), col_row=t(self.col_row))
            else:
                self._on[key] = dict(flat=t(self._slot_flat),
                                     plan=t(self.plan))
        return self._on[key]


@functools.lru_cache(maxsize=None)
def layout_pattern(layout) -> EllPattern:
    """The static pattern of a `QPLayout`'s constraint matrix: every
    position `assemble_A` writes.  Ruiz scaling keeps zeros zero, so it
    covers the scaled A too."""
    return EllPattern(layout._row_cat, layout._col_cat, layout.m, layout.n)


def pattern_from(A, mode: str = "highest", m_eq: int = 0,
                 dense_P: bool = False) -> EllPattern:
    """The union pattern of a batch A (B, m, n): every position nonzero (or
    NaN) in some instance, in the build of `mode` and `dense_P`
    (`EllPattern.for_mode`).  One host read (the positions)."""
    _, m, n = A.shape
    nz = (A != 0).any(dim=0).nonzero().cpu().numpy()
    return EllPattern(nz[:, 0], nz[:, 1], m, n).for_mode(mode, m_eq,
                                                         dense_P)


def pack(A, pattern: EllPattern):
    """A (B, m, n) -> its values in the pattern's build's form
    (`packed_shape`: the row-ELL, or the wide build's row and column
    orders), one gather; entries of A outside the pattern are dropped."""
    B, m, n = A.shape
    flat = pattern.tensors(A.device)["flat"]
    return A.reshape(B, m * n).index_select(1, flat).view(
        pattern.packed_shape(B))


def smem_bytes(n: int, m: int, row_width: int, col_width: int,
               dense_P: bool = False, mode: str = "highest") -> int:
    """Shared memory of one block of the kernel (`smem_bytes` in
    csrc/admm_dense.cu): the vectors, the row-ELL as (value, code) pairs,
    K^-1, with a dense P the (n, n) PuD, the 16-bit column-ELL, and in
    every mode but "highest" the four vectors' bf16 splits (one word an
    entry: 2 n + 2 m, the first rounded up to 4)."""
    n4 = -(-n // 4) * 4
    floats = 6 * n + 8 * m + 8 + n * n + (n * n if dense_P else 0)
    split = 0 if mode == "highest" else 4 * (n4 + n + 2 * m)
    return (4 * n4 + 8 * m * row_width + 4 * floats + 8
            + 4 * n * col_width + split)


def plan_smem(n: int, m: int, row_width: int, col_width: int,
              dense_P: bool = False, mode: str = "highest") -> int:
    """`smem_bytes`, or ValueError for a shape whose K^-1 and A (and a
    dense P) do not fit one block (n > 211 at the sparse QP's m = 290 and
    widths 11, 15; the condensed QP's n = 103, m = 200, widths 39, 79
    with its dense P take 189,148 B, 191,576 B in the split modes)."""
    need = smem_bytes(n, m, row_width, col_width, dense_P, mode)
    if need > SMEM_MAX:
        raise ValueError(
            f"the dense ADMM kernel holds K^-1, A's nonzeros"
            f"{' and P' if dense_P else ''} in one block's shared memory: "
            f"n={n}, m={m}, widths ({row_width}, {col_width}) need {need} B "
            f"of the {SMEM_MAX} B a block may use")
    return need


def smem_bytes_wide(n: int, m: int, slots: tuple, lane_warps: tuple,
                    mode: str = "highest") -> int:
    """Shared memory of one block of the wide build (`smem_bytes` in
    csrc/admm_wide.cu) for (row, column) `slots` and `lane_warps`: the
    vectors, K^-1 at row stride `kld(n)`, A's values
    in both slot orders, in every mode but "highest" the four vectors'
    words, and the pattern block (lane plans, runs, 16-bit indices)."""
    mat = n * kld(n)
    even = lambda v: v + v % 2
    sr, sc = slots
    plan = 64 * sum(lane_warps) + (even(sr) + even(sc)) // 2
    words = (7 * n + 8 * m + 8 + mat + sr + sc
             + (0 if mode == "highest" else 2 * n + 2 * m) + 2 + plan)
    return 4 * words


def plan_smem_wide(n: int, m: int, slots: tuple, lane_warps: tuple,
                   mode: str = "highest") -> int:
    """`smem_bytes_wide`, or ValueError for a shape that does not fit one
    block (the condensed QP's n = 103, m = 200, 3,105 nonzeros in 3,456
    row and 3,360 column slots of 9 and 7 lane warps take 97,164 B, a
    dense P's PuD staying in device memory)."""
    need = smem_bytes_wide(n, m, slots, lane_warps, mode)
    if need > SMEM_MAX:
        raise ValueError(
            f"the dense ADMM kernel's wide build holds K^-1 and A's "
            f"nonzeros in one block's shared memory: n={n}, m={m}, "
            f"{sum(slots)} slots need {need} B of the {SMEM_MAX} B a block "
            f"may use")
    return need


def smem_bytes_large(n: int, m: int, slots: tuple, lane_warps: tuple,
                     mode: str = "highest", pair: bool = False) -> int:
    """Shared memory of one block of the large build (`smem_bytes_large`
    in csrc/admm_large.cu): K^-1's stored rows (`large_stored_rows`: each
    part's rows past the mode's `large_kreg` register rows) at row stride
    `kld(n)` (with `pair`, a block of the pair build: all rows of its
    half's columns at row stride `pair_ld(n)` and the 2 n exchange
    words), the vectors (a column's two parts of A'v, no A x: the checks
    reduce it where it is made), the warps' maxima, A's values in both
    slot orders, in every mode but "highest" five vectors' words (x's
    too, made where x is), and the pattern block."""
    sr, sc = slots
    even = lambda v: v + v % 2
    plan = 64 * sum(lane_warps) + (even(sr) + even(sc)) // 2
    kwords = (n * pair_ld(n) + 2 * n if pair
              else large_stored_rows(n, large_kreg(mode)) * kld(n))
    words = (kwords + 9 * n + 7 * m + 8 + 8 * LARGE_WARPS + 4 + sr + sc
             + (0 if mode == "highest" else 3 * n + 2 * m) + 2 + plan)
    return 4 * words


def plan_smem_large(n: int, m: int, slots: tuple, lane_warps: tuple,
                    mode: str = "highest", dense_P: bool = False) -> int:
    """`smem_bytes_large`, or ValueError for a dense P (the large build
    takes a diagonal one), an n past LARGE_N_MAX (a warp's second K^-1
    task would have no register rows) or a shape that does not fit one
    block (the sparse decoupled QP's n = 245, m = 395 take 179,616 B in
    "highest", 185,716 B in "mixedk6" and "bf16", and 244,852 B, too
    many, in "mixed" and "high")."""
    if dense_P:
        raise ValueError("the dense ADMM kernel's large build takes a "
                         "diagonal P; a dense P takes the wide build")
    if n > LARGE_N_MAX:
        raise ValueError(f"the dense ADMM kernel's large build takes n <= "
                         f"{LARGE_N_MAX} (one K^-1 task a warp); got n={n}")
    need = smem_bytes_large(n, m, slots, lane_warps, mode)
    if need > SMEM_MAX:
        raise ValueError(
            f"the dense ADMM kernel's large build holds K^-1 and A's "
            f"nonzeros in one block's shared memory: n={n}, m={m}, "
            f"{sum(slots)} slots need {need} B of the {SMEM_MAX} B a block "
            f"may use")
    return need


def plan_smem_pair(n: int, m: int, slots: tuple, lane_warps: tuple,
                   mode: str = "highest", dense_P: bool = False) -> int:
    """Shared memory of each block of the pair build (`smem_bytes_large`
    with `pair`), or ValueError for a dense P or a shape whose half of
    K^-1 and A do not fit one block (the sparse decoupled QP's n = 245, m
    = 395, 1,375 nonzeros in 1,696 row and 1,760 column slots of 13 and 8
    lane warps take 181,800 B in "highest", its full K^-1 in the large
    build 305,280 B)."""
    if dense_P:
        raise ValueError("the dense ADMM kernel's pair build takes a "
                         "diagonal P; a dense P takes the wide build")
    need = smem_bytes_large(n, m, slots, lane_warps, mode, pair=True)
    if need > SMEM_MAX:
        raise ValueError(
            f"the dense ADMM kernel's pair build holds half of K^-1 and A's "
            f"nonzeros in each block's shared memory: n={n}, m={m}, "
            f"{sum(slots)} slots need {need} B of the {SMEM_MAX} B a block "
            f"may use")
    return need


def block_bytes(pattern: EllPattern, dense_P: bool = False,
                mode: str = "highest") -> int:
    """Shared memory one block of the pattern's build would need (each
    block of a pair in the pair build), whether it fits or not."""
    if pattern.build == "narrow":
        return smem_bytes(pattern.n, pattern.m, pattern.row_width,
                          pattern.col_width, dense_P, mode)
    if pattern.build in LARGE_FORMS:
        return smem_bytes_large(pattern.n, pattern.m, pattern.slots,
                                pattern.lane_warps, mode,
                                pattern.build == "pair")
    return smem_bytes_wide(pattern.n, pattern.m, pattern.slots,
                           pattern.lane_warps, mode)


def _fits(pattern: EllPattern, mode: str) -> bool:
    """Whether one block of the pattern's build takes it with a diagonal
    P in `mode` (`block_smem` raises no ValueError)."""
    try:
        block_smem(pattern, False, mode)
    except ValueError:
        return False
    return True


def block_smem(pattern: EllPattern, dense_P: bool = False,
               mode: str = "highest") -> int:
    """Shared memory of one block of the pattern's build (`plan_smem`,
    `plan_smem_wide`, `plan_smem_large` or `plan_smem_pair`; ValueError
    where it does not fit)."""
    if pattern.build == "narrow":
        return plan_smem(pattern.n, pattern.m, pattern.row_width,
                         pattern.col_width, dense_P, mode)
    if pattern.build == "large":
        return plan_smem_large(pattern.n, pattern.m, pattern.slots,
                               pattern.lane_warps, mode, dense_P)
    if pattern.build == "pair":
        return plan_smem_pair(pattern.n, pattern.m, pattern.slots,
                              pattern.lane_warps, mode, dense_P)
    return plan_smem_wide(pattern.n, pattern.m, pattern.slots,
                          pattern.lane_warps, mode)


# each build's kernel (`_kernels.KERNELS`) and source; the pair build is
# the large build's source
BUILD_KERNELS = {"narrow": ("admm_dense", "admm_dense.cu"),
                 "wide": ("admm_wide", "admm_wide.cu"),
                 "large": ("admm_large", "admm_large.cu"),
                 "pair": ("admm_pair", "admm_large.cu")}


def max_active_clusters(pattern: EllPattern, tile: int,
                        dense_P: bool = False, mode: str = "highest") -> int:
    """How many clusters of a tile of `tile` instances (`tile` blocks, 2
    `tile` in the pair build) of the pattern's build the card holds at
    once (cudaOccupancyMaxActiveClusters) for its shapes."""
    if pattern.build == "narrow":
        return _kernels.occupancy(
            "admm_dense.cu", "admm_dense_max_clusters", pattern.n,
            pattern.m, pattern.row_width, pattern.col_width, int(tile),
            int(dense_P), MODES.index(mode))
    kernel, source = BUILD_KERNELS[pattern.build]
    return _kernels.occupancy(
        source, f"{kernel}_max_clusters", pattern.n, pattern.m,
        *pattern.slots, *pattern.lane_warps, int(tile), int(dense_P),
        MODES.index(mode))


def registers(mode: str = "highest", dense_P: bool = False,
              build: str = "narrow") -> int:
    """Registers a thread of the kernel's `build` for `mode` and `dense_P`
    (cudaFuncGetAttributes)."""
    kernel, source = BUILD_KERNELS[build]
    return _kernels.occupancy(source, f"{kernel}_registers",
                              MODES.index(mode), int(dense_P))


def mode_of(precision: str, bf16: bool = False, m_eq: int = 0,
            m: int = 0) -> str:
    """The kernel's mode for the JAX signature's `precision` and `bf16`
    (bf16 wins, as in the JAX package); ValueError for an unknown one, or
    for a mixed mode without 0 < m_eq <= m leading equality rows."""
    mode = "bf16" if bf16 else str(precision)
    if mode not in MODES:
        raise ValueError(f"unknown precision {precision!r}")
    if mode in MIXED_MODES and not 0 < m_eq <= m:
        raise ValueError("mixed precision requires m_eq leading equality "
                         "rows (caller permutes them to the front)")
    return mode


def bf16_round(t):
    """t rounded to bfloat16 (to nearest, ties to even), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def bf16_split(t):
    """(hi, lo) = (bf16(t), bf16(t - hi)) in t's dtype: the JAX kernel's
    split of a matrix (pallas_admm.py:335-339) and of a vector (:131-132)."""
    hi = bf16_round(t)
    return hi, bf16_round(t - hi)


def _split_product(prod, v, pair):
    """The JAX kernel's _dot_split: (v_hi M_hi + v_hi M_lo) + v_lo M_hi,
    each product `prod(v, M)` summed in v's dtype."""
    hi, lo = pair
    v_hi, v_lo = bf16_split(v)
    return (prod(v_hi, hi) + prod(v_hi, lo)) + prod(v_lo, hi)


def products(Kinv, A, mode: str = "highest", m_eq: int = 0):
    """The kernel's three products in `mode`'s arithmetic (the JAX
    kernel's matA, matAT and matK, :135-158): A'v (v over rows), A v and
    v' K^-1, for batches A (B, m, n), K^-1 (B, n, n)."""
    mtv = lambda v, M: _mtv(M, v)
    mv = lambda v, M: _mv(M, v)
    if mode == "highest":
        return (lambda v: _mtv(A, v)), (lambda v: _mv(A, v)), \
            (lambda v: _mtv(Kinv, v))
    if mode == "bf16":
        Ab, Kb = bf16_round(A), bf16_round(Kinv)
        return ((lambda v: _mtv(Ab, bf16_round(v))),
                (lambda v: _mv(Ab, bf16_round(v))),
                (lambda v: _mtv(Kb, bf16_round(v))))
    if mode == "high":
        A2, K2 = bf16_split(A), bf16_split(Kinv)
        return ((lambda v: _split_product(mtv, v, A2)),
                (lambda v: _split_product(mv, v, A2)),
                (lambda v: _split_product(mtv, v, K2)))
    A_eq, A_in = A[:, :m_eq], bf16_split(A[:, m_eq:])
    K2 = bf16_split(Kinv) if mode == "mixed" else None
    return ((lambda v: _mtv(A_eq, v[:, :m_eq])
             + _split_product(mtv, v[:, m_eq:], A_in)),
            (lambda v: torch.cat([_mv(A_eq, v),
                                  _split_product(mv, v, A_in)], dim=-1)),
            (lambda v: _mtv(Kinv, v) if K2 is None
             else _split_product(mtv, v, K2)))


def _stats(matA, matAT, x, z, y, invE, PuD, qu, invDc, eps_abs, eps_rel):
    """Unscaled residual statistics (B, 8) and per-instance convergence,
    A x and A'y through the mode's products; PuD (B, n) for a diagonal P
    or (B, n, n) for a dense one (its product plain in every mode, as the
    JAX kernel's _dot6 at :190)."""
    ax = matAT(x)
    aty = matA(y)
    Ax_u = ax * invE
    z_u = z * invE
    # a dense P: P_u x_u = x_bar' (D[:, None] P_u), the JAX kernel's
    # _dot6(x, PuD)
    Px_u = _mtv(PuD, x) if PuD.dim() == 3 else PuD * x
    Aty_u = aty * invDc
    stat = lambda v: torch.abs(v).amax(dim=-1)
    zero = torch.zeros_like(stat(qu))
    st = torch.stack([stat(Ax_u - z_u), stat(Px_u + qu + Aty_u), stat(Ax_u),
                      stat(z_u), stat(Px_u), stat(Aty_u), zero, zero],
                     dim=-1)
    eps_p = eps_abs + eps_rel * torch.maximum(st[:, 2], st[:, 3])
    eps_d = eps_abs + eps_rel * torch.maximum(
        torch.maximum(st[:, 4], st[:, 5]), stat(qu))
    return st, (st[:, 0] <= eps_p) & (st[:, 1] <= eps_d)


def admm_iterations_plain(Kinv, A, q, l, u, rho, x, z, y, E, PuD, qu, invDc,
                          n_iters: int, sigma: float, alpha: float,
                          tile: int = 1, check: int = 0,
                          eps_abs: float = 1e-3, eps_rel: float = 1e-3,
                          mode: str = "highest", m_eq: int = 0):
    """Plain PyTorch version of the dense ADMM kernel, with its early exit
    per tile of `tile` consecutive instances: (x, z, y, stats).  PuD is
    (B, n), or (B, n, n) for a dense P.  `mode` (one of MODES) and `m_eq`
    as `products`; in float64 the bf16 roundings stay and the sums run in
    float64."""
    B = q.shape[0]
    inv_rho = 1.0 / rho
    invE = 1.0 / E
    matA, matAT, matK = products(Kinv, A, mode, m_eq)

    def body(x, z, y):
        w = rho * z - y
        rhs = sigma * x - q + matA(w)
        xt = matK(rhs)
        zt = matAT(xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        z_mix = alpha * zt + (1.0 - alpha) * z
        z_n = torch.clamp(z_mix + y * inv_rho, l, u)
        return x_n, z_n, y + rho * (z_mix - z_n)

    stats_of = lambda x, z, y: _stats(matA, matAT, x, z, y, invE, PuD, qu,
                                      invDc, eps_abs, eps_rel)
    if 0 < check < n_iters:
        n_tiles = -(-B // tile)
        active = torch.ones(B, dtype=torch.bool, device=q.device)
        executed = torch.zeros(B, dtype=q.dtype, device=q.device)
        stats = torch.zeros((B, 8), dtype=q.dtype, device=q.device)
        for it in range(-(-n_iters // check)):
            k_len = min(check, n_iters - it * check)
            a1 = active[:, None]
            for _ in range(k_len):
                x_n, z_n, y_n = body(x, z, y)
                x = torch.where(a1, x_n, x)
                z = torch.where(a1, z_n, z)
                y = torch.where(a1, y_n, y)
            st, conv = stats_of(x, z, y)
            stats = torch.where(a1, st, stats)
            executed = torch.where(active, executed + k_len, executed)
            # instances past B count as converged
            padded = torch.ones(n_tiles * tile, dtype=torch.bool,
                                device=q.device)
            padded[:B] = conv
            tile_done = padded.view(n_tiles, tile).all(dim=1)
            active = active & ~tile_done.repeat_interleave(tile)[:B]
            if not bool(active.any()):
                break
        stats[:, 6] = executed
    else:
        for _ in range(n_iters):
            x, z, y = body(x, z, y)
        stats, _ = stats_of(x, z, y)
        stats[:, 6] = float(n_iters)
    return x, z, y, stats


def admm_iterations(Kinv, A, q, l, u, rho, x0, z0, y0, n_iters: int,
                    sigma: float, alpha: float, tile: int = 1,
                    bf16: bool = False, precision: str = "highest",
                    scalings=None, m_eq: int = 0, check: int = 0,
                    eps_abs: float = 1e-3, eps_rel: float = 1e-3,
                    dense_P: bool = False, pattern: EllPattern = None,
                    A_packed=None):
    """Run up to `n_iters` ADMM iterations for a batch of scaled QPs:
    Kinv (B, n, n), A (B, m, n), q, x0 (B, n), l, u, rho, z0, y0 (B, m).
    Returns (x, z, y, stats) with stats (B, 8) the unscaled residual
    statistics [r_prim, r_dual, max|Ax|, max|z|, max|Px|, max|A'y|,
    executed iterations, 0].

    scalings: (D, E, c, P_unscaled, q_unscaled) of the Ruiz step for the
    statistics, P_unscaled (B, n) or, with `dense_P`, (B, n, n); identity
    scalings (and no P term) when omitted.
    `check` > 0 checks convergence every `check` iterations and stops a
    tile of `tile` consecutive instances once all of them have converged.

    `precision` ("highest", "mixed", "mixedk6", "high") and `bf16` (which
    wins: "bf16") select the mode, as in the JAX package; the mixed modes
    take the `m_eq` leading rows of A as its equality rows (ValueError
    unless 0 < m_eq <= m), which other modes ignore.

    Replaces the TPU kernel `pigeon_tpu/solver/pallas_admm.py:_kernel`
    (every mode, with its `dense_P` branch).  One block per instance
    holds its K^-1 and A's nonzeros (and, in the narrow build, a dense
    PuD) in shared memory for the call (`block_smem` raises
    ValueError for shapes that do not fit), and a tile is a thread block
    cluster; the kernel splits K^-1 and A into their bf16 forms where it
    loads them, so `A_packed` is the same in every mode.
    `pattern`: A's nonzero pattern (an `EllPattern` covering every nonzero
    of every instance; the pipeline passes its layout's in the build of
    its mode); without one the union pattern of the batch is derived from
    A, with one host read, in the build `plan_build` gives its widths and
    the mode.  The pattern's build is the kernel's: the narrow one
    (`csrc/admm_dense.cu`), the wide one (`csrc/admm_wide.cu`) or the
    large one (`csrc/admm_large.cu`), which takes a diagonal P and in a
    mixed mode its rows split at `m_eq` (ValueError otherwise), or that
    source's pair build, an instance on a pair of blocks and a tile a
    cluster of 2 `tile` blocks (so `tile` <= PAIR_TILE_MAX).
    `A_packed`: `pack(A, pattern)` when the caller has it already (the
    pipeline packs once per solve); else the wrapper packs, one gather.
    Both are used only on the card: the CPU runs the dense plain
    version."""
    B, m, n = A.shape
    mode = mode_of(precision, bf16, m_eq, m)
    m_eq = int(m_eq) if mode in MIXED_MODES else 0
    if scalings is None:
        D = torch.ones_like(q)
        E = torch.ones_like(l)
        c = torch.ones((B,), dtype=q.dtype, device=q.device)
        Pu = torch.zeros((B, n, n) if dense_P else (B, n), dtype=q.dtype,
                         device=q.device)
        qu = q
    else:
        D, E, c, Pu, qu = scalings
    # a symmetric dense P: x_bar' (D[:, None] P_u) = P_u (D x_bar) = P_u x_u
    PuD = D[:, :, None] * Pu if dense_P else Pu * D
    invDc = 1.0 / (D * c[:, None])
    ops = dict(Kinv=(Kinv, (B, n, n)), A=(A, (B, m, n)), q=(q, (B, n)),
               l=(l, (B, m)), u=(u, (B, m)), rho=(rho, (B, m)),
               x0=(x0, (B, n)), z0=(z0, (B, m)), y0=(y0, (B, m)),
               E=(E, (B, m)), PuD=(PuD, (B, n, n) if dense_P else (B, n)),
               qu=(qu, (B, n)),
               invDc=(invDc, (B, n)))
    _kernels.check_same(**ops)
    if q.device.type == "cpu":
        return admm_iterations_plain(
            Kinv, A, q, l, u, rho, x0, z0, y0, E, PuD, qu, invDc, n_iters,
            sigma, alpha, tile, check, eps_abs, eps_rel, mode, m_eq)
    if not 1 <= tile <= TILE_MAX:
        raise ValueError(f"the CUDA kernel takes 1 <= tile <= {TILE_MAX} "
                         f"(a cluster of `tile` blocks); got tile={tile}")
    if pattern is None:
        pattern = pattern_from(A, mode, m_eq, dense_P)
    if (pattern.m, pattern.n) != (m, n):
        raise ValueError(f"the pattern is of a {pattern.m} x {pattern.n} "
                         f"matrix, A of {m} x {n}")
    if pattern.build == "pair" and tile > PAIR_TILE_MAX:
        raise ValueError(f"the pair build's tile is a cluster of 2 tile "
                         f"blocks: 1 <= tile <= {PAIR_TILE_MAX}, got "
                         f"tile={tile}")
    if (pattern.build in LARGE_FORMS and mode in MIXED_MODES
            and pattern.m_split != m_eq):
        raise ValueError(f"the {pattern.build} build's pattern splits its "
                         f"rows at {pattern.m_split}, the mode's equality "
                         f"rows end at {m_eq}")
    block_smem(pattern, dense_P, mode)
    if A_packed is None:
        A_packed = pack(A, pattern)
    _kernels.check_same(A_packed=(A_packed, pattern.packed_shape(B)),
                        q=(q, (B, n)))
    _kernels.check_cuda_f32(A_packed=A_packed,
                            **{k: v[0] for k, v in ops.items()})
    pat = pattern.tensors(q.device)
    x, z, y = x0.clone(), z0.clone(), y0.clone()
    stats = torch.empty((B, 8), dtype=q.dtype, device=q.device)
    tail = (int(tile), int(n_iters), int(dense_P))
    mode_args = (MODES.index(mode), m_eq, float(sigma), float(alpha),
                 int(check), float(eps_abs), float(eps_rel))
    tag = mode + ("_dense_P" if dense_P else "")
    vectors = (q, l, u, rho, x, z, y, E, PuD, qu, invDc, stats)
    if pattern.build != "narrow":
        _kernels.KERNELS[BUILD_KERNELS[pattern.build][0]].launch(
            Kinv, A_packed, pat["plan"], *vectors, B, n, m,
            *pattern.slots, *pattern.lane_warps, *tail, *mode_args,
            tag=tag)
    else:
        _kernels.KERNELS["admm_dense"].launch(
            Kinv, A_packed, pat["row_code"], pat["col_slot"],
            pat["col_row"], *vectors, B, n, m, pattern.row_width,
            pattern.col_width, *tail, *mode_args, tag=tag)
    return x, z, y, stats
