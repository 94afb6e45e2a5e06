"""Shared QP constants (counterpart of `pigeon_tpu/qp/structure.py`)."""

import math

INF = math.inf
