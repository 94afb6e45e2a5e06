"""QP assembly scaffolding (counterpart of `pigeon_tpu/qp/structure.py`).

`QPLayout` plans variable and constraint indices with numpy once per
horizon shape; `assemble_A` scatters the value arrays of a batch into the
dense (B, m, n) constraint matrices with one accumulating `index_put_`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

INF = math.inf


class QPLayout:
    """Static index bookkeeping for one QP formulation: variables and
    constraint rows are allocated once as numpy index arrays; assembly only
    touches values."""

    def __init__(self):
        self.n = 0
        self.m = 0
        self._triplets = []        # (row_idx, col_idx) pairs, flattened
        self._finalized = False

    def add_vars(self, shape) -> np.ndarray:
        """Allocate a block of variables; returns its index array."""
        size = int(np.prod(shape))
        idx = np.arange(self.n, self.n + size).reshape(shape)
        self.n += size
        return idx

    def add_rows(self, count: int) -> np.ndarray:
        idx = np.arange(self.m, self.m + count)
        self.m += count
        return idx

    def entry(self, rows: np.ndarray, cols: np.ndarray):
        """Register nonzero positions (rows and cols broadcast together);
        `assemble_A` takes their values in the same order.  Returns the
        slot id."""
        rows_b, cols_b = np.broadcast_arrays(rows, cols)
        self._triplets.append((rows_b.ravel(), cols_b.ravel()))
        return len(self._triplets) - 1

    def finalize(self):
        self._row_cat = np.concatenate([r for r, _ in self._triplets])
        self._col_cat = np.concatenate([c for _, c in self._triplets])
        self._sizes = [r.size for r, _ in self._triplets]
        self._finalized = True

    def assemble_A(self, values: list) -> torch.Tensor:
        """values[i]: (B, *shape of the i-th entry()) -> A (B, m, n)."""
        assert self._finalized
        B = values[0].shape[0]
        flat = []
        for v, size in zip(values, self._sizes):
            v = v.reshape(B, -1)
            if v.shape[1] != size:
                raise ValueError(f"entry of {v.shape[1]} values, expected "
                                 f"{size}")
            flat.append(v)
        vals = torch.cat(flat, dim=1)
        dev = vals.device
        A = torch.zeros((B, self.m, self.n), dtype=vals.dtype, device=dev)
        rows = torch.as_tensor(self._row_cat, device=dev)[None, :]
        cols = torch.as_tensor(self._col_cat, device=dev)[None, :]
        bidx = torch.arange(B, device=dev)[:, None]
        return A.index_put_((bidx, rows, cols), vals, accumulate=True)
