"""The roofline's counts on a QP whose work is known by hand, and the
static nonzeros of the configurations' layouts."""

import torch

from benchmark.counts import admm
from benchmark.reference import controller as ct


def test_operations_by_hand():
    # n = 2, m = 3, 4 nonzeros, check every 10: one solve of 20 iterations
    # and one of 5 (one check, rounded up)
    per_it = 4 * 4 + 2 * 2 * 2 + 10 * 3 + 5 * 2
    per_check = 4 * 4 + 10 * 3 + 12 * 2
    got = admm.operations(torch.tensor([20, 5]), 2, 3, 4, 10)
    assert got == 25 * per_it + 3 * per_check


def test_bytes_by_hand():
    n, m, nnz = 2, 3, 4
    reads = n * n + nnz + 5 * n + 6 * m + 1
    writes = n + 2 * m + 8
    assert admm.bytes_per_step(5, n, m, nnz) == (
        5 * 4 * (reads + writes) + 2 * nnz + 4 * (m + 1))


def test_least_time_takes_the_larger_bound():
    peaks = dict(fp32_flops_per_s=10.0, hbm_bytes_per_s=100.0)
    assert admm.least_seconds(50.0, 100.0, peaks) == 5.0
    assert admm.least_seconds(5.0, 1000.0, peaks) == 10.0


def test_layouts_sizes_and_static_nonzeros():
    cs = ct.layout(ct.SPECS["coupled_sparse"])
    ds = ct.layout(ct.SPECS["decoupled_sparse"])
    assert (cs.n, cs.m) == (193, 290) and (ds.n, ds.m) == (245, 395)
    # the program's packed patterns (PERF.md's kernel table, B8 rows)
    assert cs.nonzeros() == 1320 and ds.nonzeros() == 1375


def test_kernel_names():
    for name in ("void admm_dense_kernel<0, false>(Args)",
                 "admm_large_kernel<2, true>", "admm_wide_kernel<0>"):
        assert admm.KERNEL.search(name)
    assert not admm.KERNEL.search("admm_iterations_kernel")
