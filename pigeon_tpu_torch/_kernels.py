"""Build, load and launch the port's CUDA kernels.

Each source in `csrc/` is compiled by `nvcc` for Hopper (`sm_90a`) into its
own shared library with a plain C interface, and loaded with `ctypes`.
Builds go to `pigeon_tpu_torch/_build/` (listed in `.gitignore`), named by
a hash of the source and flags, so an edited source rebuilds on first use
and an unchanged one loads at once.  `build_all()` starts one `nvcc` per
source, all together.

Every C entry point takes raw pointers and the current CUDA stream, never
allocates, and returns `cudaGetLastError()`; `Kernel.launch` raises if
that is not 0 and counts the launch.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float


def _load(source: str, name: str, argtypes: list):
    fn = getattr(ctypes.CDLL(str(build(source))), name)
    fn.argtypes = argtypes
    fn.restype = _I
    return fn


class Kernel:
    """One C entry point of one source file; `launches` counts the calls
    that launched it, and `launches_by` those of each build a caller
    names (`tag`)."""

    def __init__(self, name: str, source: str, argtypes: list):
        self.name = name
        self.source = source
        self.argtypes = argtypes + [_P]          # trailing stream
        self.launches = 0
        self.launches_by = {}
        self._fn = None

    def launch(self, *args, tag: str = None):
        if self._fn is None:
            self._fn = _load(self.source, self.name, self.argtypes)
        conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = self._fn(*conv, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")
        self.launches += 1
        if tag is not None:
            self.launches_by[tag] = self.launches_by.get(tag, 0) + 1


KERNELS = {
    "vanloan": Kernel("vanloan_f32", "vanloan.cu",
                      [_P] * 8 + [_L, _I, _I, _I, _I]),
    "chol_inverse": Kernel("chol_inverse_f32", "chol_inverse.cu",
                           [_P, _P, _L, _I, _I]),
    "admm_iterations": Kernel(
        "admm_iterations_f32", "admm_iterations.cu",
        [_P] * 15 + [_I, _I, _I, _I, _F, _F, _I, _F, _F]),
    "rollout": Kernel("rollout_f32", "rollout.cu",
                      [_P, _P, _P, _L, _I, _I, _I]),
    "expm_dense": Kernel("expm_dense_f32", "expm_dense.cu",
                         [_P, _P, _L, _I, _I, _I, _I]),
    "ruiz": Kernel("ruiz_f32", "ruiz.cu", [_P] * 13 + [_I] * 5),
    "banded_chol": Kernel("banded_chol_f32", "banded_chol.cu",
                          [_P] * 4 + [_L, _I, _I, _I]),
    "admm_dense": Kernel(
        "admm_dense_f32", "admm_dense.cu",
        [_P] * 17 + [_I] * 10 + [_F, _F, _I, _F, _F]),
    "admm_wide": Kernel(
        "admm_wide_f32", "admm_wide.cu",
        [_P] * 15 + [_I] * 12 + [_F, _F, _I, _F, _F]),
    "admm_large": Kernel(
        "admm_large_f32", "admm_large.cu",
        [_P] * 15 + [_I] * 12 + [_F, _F, _I, _F, _F]),
    "admm_pair": Kernel(
        "admm_pair_f32", "admm_large.cu",
        [_P] * 15 + [_I] * 12 + [_F, _F, _I, _F, _F]),
}


def occupancy(source: str, name: str, *args: int) -> int:
    """What a host-side occupancy helper of `source` reports (resident
    blocks per SM, or clusters on the card) for its int arguments `args`;
    nothing is launched or counted.  Raises if the helper returns an
    error."""
    out = ctypes.c_int(0)
    err = _load(source, name, [_I] * len(args) + [_P])(
        *args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err}")
    return out.value


def reset_launches():
    for k in KERNELS.values():
        k.launches = 0
        k.launches_by = {}


def launches() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}


def launches_by(name: str) -> dict:
    """The launches of kernel `name` by build (the wrapper's tags: the
    dense ADMM kernel's mode, "_dense_P" added for its dense-P build, in
    its narrow ("admm_dense"), wide ("admm_wide"), large ("admm_large")
    and pair ("admm_pair") build)."""
    return dict(KERNELS[name].launches_by)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


_build_lock = threading.Lock()


def _target(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    for inc in sorted(CSRC.glob("*.cuh")):
        text += inc.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _start(source: str, target: Path):
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", str(tmp), str(CSRC / source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp


def _finish(source: str, target: Path, proc, tmp: Path) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{out}")
    os.replace(tmp, target)
    return out


def build(source: str) -> Path:
    """Path of the built library for `source`, compiling it if needed."""
    target = _target(source)
    with _build_lock:
        if not target.exists():
            proc, tmp = _start(source, target)
            _finish(source, target, proc, tmp)
    return target


def build_all() -> dict:
    """Build every source that is not built yet, one nvcc each, all in
    parallel.  Returns nvcc's output (ptxas register and spill report)
    for each source it compiled."""
    sources = sorted({k.source for k in KERNELS.values()})
    with _build_lock:
        pending = []
        for src in sources:
            target = _target(src)
            if not target.exists():
                pending.append((src, target) + _start(src, target))
        return {src: _finish(src, target, proc, tmp)
                for src, target, proc, tmp in pending}


# ---------------------------------------------------------------------------
# Argument checks shared by the wrappers
# ---------------------------------------------------------------------------

def check_same(**named):
    """Each value is (tensor, expected shape); all on one device and of
    one floating dtype."""
    first = None
    for name, (t, shape) in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if first is None:
            first = t
            if not t.is_floating_point():
                raise TypeError(f"{name} must be floating point")
        elif t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; expected "
                             f"{first.dtype} on {first.device}")


def check_cuda_f32(**named):
    for name, t in named.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 for the kernel, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
