"""ctypes bindings for the native autobox transport
(`runtime/native/autobox_link.cpp`): a non-blocking UDP link to the
vehicle's ECU and an in-process single-producer/single-consumer ring of
state frames for benchmark-mode streaming.  Counterpart of
`pigeon_tpu/runtime/transport.py`.

The library is compiled with the system `c++` on first use into the
git-ignored `pigeon_tpu_torch/_build/`, named by a hash of the source and
flags; a failed or impossible build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Optional

from pigeon_tpu_torch.runtime.loop import FromAutobox, ToAutobox

NATIVE_SRC = Path(__file__).resolve().parent / "native" / "autobox_link.cpp"
BUILD = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]
_LIB = None
_lib_lock = threading.Lock()

# struct formats matching the packed wire structs in autobox_link.cpp
_FROM_FMT = "<Id6di"      # seq, stamp, 6x state, pre_flag
_TO_FMT = "<diI5d"        # stamp, post_flag, heartbeat, s, e, 3x cmd
_FROM_SIZE = struct.calcsize(_FROM_FMT)
_TO_SIZE = struct.calcsize(_TO_FMT)


def _build_lib() -> Path:
    """Path of the built shared library, compiling it if needed."""
    digest = hashlib.sha256(NATIVE_SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode())
    target = BUILD / f"autobox_link-{digest.hexdigest()[:16]}.so"
    if target.exists():
        return target
    cxx = shutil.which("c++")
    if cxx is None:
        raise RuntimeError("c++ not found: the autobox transport is built "
                           "with the system C++ compiler")
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx] + CXX_FLAGS + [str(NATIVE_SRC), "-o",
                                               str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"c++ failed on {NATIVE_SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def get_lib() -> ctypes.CDLL:
    global _LIB
    with _lib_lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_lib()))
            lib.ab_open.restype = ctypes.c_void_p
            lib.ab_open.argtypes = [ctypes.c_uint16, ctypes.c_char_p,
                                    ctypes.c_uint16]
            lib.ab_recv_state.restype = ctypes.c_int
            lib.ab_recv_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ab_send_cmd.restype = ctypes.c_int
            lib.ab_send_cmd.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ab_close.argtypes = [ctypes.c_void_p]
            lib.ring_create.restype = ctypes.c_void_p
            lib.ring_create.argtypes = [ctypes.c_uint32]
            lib.ring_push.restype = ctypes.c_int
            lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ring_pop.restype = ctypes.c_int
            lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.ring_destroy.argtypes = [ctypes.c_void_p]
            # the wire sizes agree between C++ and Python
            assert lib.ab_from_size() == _FROM_SIZE, (lib.ab_from_size(),
                                                      _FROM_SIZE)
            assert lib.ab_to_size() == _TO_SIZE, (lib.ab_to_size(),
                                                  _TO_SIZE)
            _LIB = lib
    return _LIB


def pack_state(msg: FromAutobox) -> bytes:
    return struct.pack(_FROM_FMT, msg.seq, msg.stamp, msg.E_m, msg.N_m,
                       msg.psi_rad, msg.ux_mps, msg.uy_mps, msg.r_radps,
                       msg.pre_flag)


def unpack_state(buf: bytes) -> FromAutobox:
    seq, stamp, E, N, psi, ux, uy, r, pre = struct.unpack(_FROM_FMT, buf)
    return FromAutobox(seq=seq, stamp=stamp, E_m=E, N_m=N, psi_rad=psi,
                       ux_mps=ux, uy_mps=uy, r_radps=r, pre_flag=pre)


def pack_cmd(cmd: ToAutobox) -> bytes:
    return struct.pack(_TO_FMT, cmd.stamp, cmd.post_flag, cmd.heartbeat,
                       cmd.s_m, cmd.e_m, cmd.delta_cmd_rad, cmd.fxf_cmd_N,
                       cmd.fxr_cmd_N)


def unpack_cmd(buf: bytes) -> ToAutobox:
    stamp, post, hb, s, e, d, fxf, fxr = struct.unpack(_TO_FMT, buf)
    return ToAutobox(stamp=stamp, post_flag=post, heartbeat=hb, s_m=s,
                     e_m=e, delta_cmd_rad=d, fxf_cmd_N=fxf, fxr_cmd_N=fxr)


class AutoboxLink:
    """Non-blocking UDP endpoint for the ECU link: receives state frames on
    `recv_port` (keeping only the freshest), sends commands to the peer."""

    def __init__(self, recv_port: int, peer_host: str = "",
                 peer_port: int = 0):
        self._lib = get_lib()
        self._h = self._lib.ab_open(recv_port, peer_host.encode(),
                                    peer_port)
        if not self._h:
            raise OSError(f"failed to open autobox link on :{recv_port}")

    def recv_state(self) -> Optional[FromAutobox]:
        buf = ctypes.create_string_buffer(_FROM_SIZE)
        if self._lib.ab_recv_state(self._h, buf):
            return unpack_state(buf.raw)
        return None

    def send_cmd(self, cmd: ToAutobox) -> bool:
        return self._lib.ab_send_cmd(self._h, pack_cmd(cmd)) == 0

    def close(self):
        if self._h:
            self._lib.ab_close(self._h)
            self._h = None


class StateRing:
    """In-process SPSC ring of state frames (benchmark streamer)."""

    def __init__(self, capacity_pow2: int = 1024):
        assert capacity_pow2 & (capacity_pow2 - 1) == 0
        self._lib = get_lib()
        self._h = self._lib.ring_create(capacity_pow2)

    def push(self, msg: FromAutobox) -> bool:
        return bool(self._lib.ring_push(self._h, pack_state(msg)))

    def pop(self) -> Optional[FromAutobox]:
        buf = ctypes.create_string_buffer(_FROM_SIZE)
        if self._lib.ring_pop(self._h, buf):
            return unpack_state(buf.raw)
        return None

    def destroy(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None
