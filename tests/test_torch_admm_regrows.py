"""The large build's K^-1 in registers and in shared memory
(`csrc/admm_large.cu`): a K^-1 lane keeps the first `large_kreg(mode)`
rows of its part in registers, loaded from device memory, and the block
stores only the other rows of each part, compacted at the row stride
`kld(n)`.  On the CPU: the row map covers K^-1 once, the stored parts keep
the bank spread of the K^-1 product's loads, the block's bytes at the
sparse decoupled QP's shapes, and the K^-1 product summed from the
compacted rows as the kernel sums it gives the bits it gave with every row
stored (the kernel runs only on the card, in chip_smoke.py)."""

import numpy as np
import pytest

from pigeon_tpu_torch import mpc as TM
from pigeon_tpu_torch.config import SolverOptions as TSO
from pigeon_tpu_torch.solver import pallas_admm as TP

EPS32 = float(np.finfo(np.float32).eps)


def _parts(n):
    """Each part's rows [j0, j1) (csrc/admm_large.cu's `LKLane`)."""
    run = TP.large_k_run(n)
    return [(min(p * run, n), min(p * run + run, n))
            for p in range(TP.LARGE_K_PARTS)]


def _stored_row_of(i, n, kreg):
    """The row of K^-1 at stored row i (`load_large`'s copy)."""
    return i + (i // (TP.large_k_run(n) - kreg) + 1) * kreg


@pytest.mark.parametrize("kreg", [8, 16])
def test_register_and_stored_rows_cover_once(kreg):
    """For every n the large build takes (1..256): the register rows (a
    part's first kreg) and the stored rows (row j of part p at j - (p +
    1) kreg) put each row of K^-1 in one place, the stored ones at 0 ..
    `large_stored_rows` - 1 exactly once, and `load_large`'s map from a
    stored row back to its row of K^-1 is the inverse.  A part's stored
    run is 2 mod 4 rows where it has one, so with the row stride 8 mod 32
    the two parts of a quarter warp read 16 banks apart."""
    assert TP.large_kreg("mixed") == TP.large_kreg("high") == 8
    assert {TP.large_kreg(m) for m in ("highest", "mixedk6", "bf16")} == {16}
    for n in range(1, TP.LARGE_N_MAX + 1):
        assert -(-n // TP.LARGE_K_TASK) <= TP.LARGE_WARPS
        stored = TP.large_stored_rows(n, kreg)
        place = {}
        for p, (j0, j1) in enumerate(_parts(n)):
            for j in range(j0, j1):
                assert j not in place
                place[j] = (("reg", p, j - j0) if j - j0 < kreg
                            else ("smem", j - (p + 1) * kreg))
            srun = TP.large_k_run(n) - kreg
            if j1 - j0 > kreg:
                assert srun % 4 == 2 and j0 == p * TP.large_k_run(n)
        assert sorted(place) == list(range(n))
        smem = sorted(v[1] for v in place.values() if v[0] == "smem")
        assert smem == list(range(stored))
        for j, v in place.items():
            if v[0] == "smem":
                assert _stored_row_of(v[1], n, kreg) == j
        srun = TP.large_k_run(n) - kreg
        if srun > 0:
            assert TP.kld(n) % 32 == 8
            assert srun * TP.kld(n) % 32 == 16


def test_decoupled_block_bytes():
    """The large block at the sparse decoupled QP's pattern (n = 245, m =
    395; 1,696 row and 1,760 column slots of 13 and 8 lane warps): 126 of
    K^-1's rows stored at row stride 264 (parts of 34 rows, 16 in
    registers, the last part's 7 all in registers) and the rest of the
    block: 179,616 B in "highest", 185,716 B with the five vectors' words
    ("mixedk6", "bf16"); with 8 register rows 182 rows stay, 244,852 B in
    "high", past 227 KB.  The pair's 181,800 B are unchanged."""
    pat = TM._a_pattern_for(TM.x1_decoupled_config(
        solver=TSO(backend="pallas"))).as_build("large")
    args = (245, 395, (1696, 1760), (13, 8))
    assert (pat.slots, pat.lane_warps) == args[2:]
    assert TP.large_k_run(245) == 34 and TP.kld(245) == 264
    assert TP.large_stored_rows(245, 16) == 126
    assert TP.large_stored_rows(245, 8) == 182
    got = {mode: TP.smem_bytes_large(*args, mode=mode)
           for mode in ("highest", "mixedk6", "bf16", "high", "mixed")}
    assert got == dict(highest=179616, mixedk6=185716, bf16=185716,
                       high=244852, mixed=244852)
    assert got["highest"] - 4 * 126 * 264 == 46560
    assert TP.block_smem(pat) == 179616
    assert TP.plan_smem_large(*args, mode="bf16") == 185716
    with pytest.raises(ValueError):
        TP.plan_smem_large(*args, mode="high")
    assert TP.smem_bytes_large(*args, pair=True) == 181800


def _k_product(K, v, kreg, compact):
    """xt = v' K^-1 in float32 as the large build sums it: lane (warp t,
    part p) adds its part's rows in ascending order, the first kreg from
    its registers (zero past the part's rows and past n), the rest from
    shared memory, then the parts are added in the xor butterfly.  Shared
    memory holds every row (`compact` False) or only the stored ones; a
    task's columns past the row stride read the next words (dropped)."""
    n = K.shape[0]
    ld = TP.kld(n)
    tasks = -(-n // TP.LARGE_K_TASK)
    rows = TP.large_stored_rows(n, kreg) if compact else n
    flat = np.full(rows * ld + TP.LARGE_K_TASK, np.nan, np.float32)
    S = flat[:rows * ld].reshape(rows, ld)
    for i in range(rows):
        S[i, :n] = K[_stored_row_of(i, n, kreg) if compact else i]
    xt = np.zeros(n, np.float32)
    for t in range(tasks):
        cols = t * TP.LARGE_K_TASK + np.arange(TP.LARGE_K_TASK)
        sums = []
        for p, (j0, j1) in enumerate(_parts(n)):
            acc = np.zeros(cols.size, np.float32)
            for i in range(kreg):
                j = j0 + i
                w = (np.where(cols < n, K[j, np.minimum(cols, n - 1)], 0.0)
                     if j < j1 else np.zeros(cols.size))
                vj = v[j] if j < j1 else 0.0
                acc = (acc + np.float32(vj) * w.astype(np.float32)).astype(
                    np.float32)
            shift = (p + 1) * kreg if compact else 0
            for j in range(min(j0 + kreg, j1), j1):
                w = flat[(j - shift) * ld + cols]
                acc = (acc + np.float32(v[j]) * w).astype(np.float32)
            sums.append(acc)
        add = lambda a, b: (a + b).astype(np.float32)
        tot = add(add(add(sums[0], sums[1]), add(sums[2], sums[3])),
                  add(add(sums[4], sums[5]), add(sums[6], sums[7])))
        keep = cols < n
        xt[cols[keep]] = tot[keep]
    return xt


@pytest.mark.parametrize("n", [245, 193, 205, 256, 241, 100, 17, 1])
def test_k_product_same_bits_from_the_stored_rows(n):
    """The K^-1 product read from the compacted rows gives the bits it gave
    with all n rows stored, with either count of register rows (the part
    that ends inside its register rows, part 7 at n = 245, and the
    columns past n included), and it is v' K^-1 within float32 rounding."""
    rng = np.random.default_rng(n)
    K = rng.normal(size=(n, n)).astype(np.float32)
    v = rng.normal(size=n).astype(np.float32)
    exact = v.astype(np.float64) @ K.astype(np.float64)
    scale = np.abs(v.astype(np.float64)) @ np.abs(K.astype(np.float64))
    for kreg in (8, 16):
        compact = _k_product(K, v, kreg, True)
        np.testing.assert_array_equal(compact, _k_product(K, v, kreg, False))
        bar = 2 * (TP.large_k_run(n) + 3) * EPS32 * scale
        assert (np.abs(compact - exact) <= bar).all()
