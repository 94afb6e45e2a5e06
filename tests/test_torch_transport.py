"""pigeon_tpu_torch.runtime.transport against pigeon_tpu.runtime.transport:
the wire formats byte for byte (no tolerance: the frames are packed
structs), the native library's own copy of the source, its wire sizes,
the SPSC ring and the UDP link over loopback."""

import dataclasses
import filecmp
import socket
import time
from pathlib import Path

import pytest

from pigeon_tpu.runtime import transport as JTP
from pigeon_tpu.runtime.loop import FromAutobox as JFrom
from pigeon_tpu.runtime.loop import ToAutobox as JTo
from pigeon_tpu_torch.runtime import transport as TTP
from pigeon_tpu_torch.runtime.loop import FromAutobox, ToAutobox

REPO = Path(__file__).resolve().parents[1]

STATES = [dict(seq=7, stamp=1.25, E_m=1.0, N_m=2.0, psi_rad=0.1, ux_mps=8.0,
               uy_mps=0.2, r_radps=0.05, pre_flag=1),
          dict(seq=2 ** 32 - 1, stamp=-3.5e9, E_m=-1e-300, N_m=1e300,
               psi_rad=-3.14159, ux_mps=0.5, uy_mps=-0.0, r_radps=7.0,
               pre_flag=0)]
COMMANDS = [dict(stamp=1.25, post_flag=1, heartbeat=9, s_m=10.0, e_m=-0.3,
                 delta_cmd_rad=0.02, fxf_cmd_N=0.0, fxr_cmd_N=500.0),
            dict(stamp=0.0, post_flag=-2, heartbeat=2 ** 32 - 1, s_m=-1.0,
                 e_m=1e-12, delta_cmd_rad=-0.4, fxf_cmd_N=-5600.0,
                 fxr_cmd_N=1e5)]


def test_native_source_is_the_reference_copy():
    port = REPO / "pigeon_tpu_torch/runtime/native/autobox_link.cpp"
    assert filecmp.cmp(port, REPO / "pigeon_tpu/runtime/native/"
                       "autobox_link.cpp", shallow=False)
    assert TTP.NATIVE_SRC == port


@pytest.mark.parametrize("fields", STATES)
def test_state_frames(fields):
    msg = FromAutobox(**fields)
    buf = TTP.pack_state(msg)
    assert buf == JTP.pack_state(JFrom(**fields))
    assert TTP.unpack_state(buf) == msg
    assert dataclasses.asdict(JTP.unpack_state(buf)) == fields


@pytest.mark.parametrize("fields", COMMANDS)
def test_command_frames(fields):
    cmd = ToAutobox(**fields)
    buf = TTP.pack_cmd(cmd)
    assert buf == JTP.pack_cmd(JTo(**fields))
    assert TTP.unpack_cmd(buf) == cmd
    assert dataclasses.asdict(JTP.unpack_cmd(buf)) == fields


def test_wire_sizes_and_build_dir():
    lib = TTP.get_lib()
    assert lib.ab_from_size() == TTP._FROM_SIZE == JTP._FROM_SIZE == 64
    assert lib.ab_to_size() == TTP._TO_SIZE == JTP._TO_SIZE == 56
    built = TTP._build_lib()
    assert built.parent == REPO / "pigeon_tpu_torch/_build"
    assert built.exists() and TTP.get_lib() is lib


def test_build_failure_raises(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text("extern \"C\" int ab_from_size( { return 0; }\n")
    monkeypatch.setattr(TTP, "NATIVE_SRC", broken)
    monkeypatch.setattr(TTP, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        TTP._build_lib()
    monkeypatch.setattr(TTP.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="c\\+\\+ not found"):
        TTP._build_lib()
    assert not list((tmp_path / "build").glob("*.so"))


def _msg(seq):
    return FromAutobox(seq=seq, stamp=0.01 * seq, E_m=float(seq), N_m=5.0,
                       psi_rad=0.0, ux_mps=5.0, uy_mps=0.0, r_radps=0.0)


def test_state_ring():
    ring = TTP.StateRing(8)
    try:
        assert ring.pop() is None
        for seq in range(5):
            assert ring.push(_msg(seq))
        for seq in range(5):
            assert ring.pop() == _msg(seq)
        assert ring.pop() is None
        # capacity 8: the ninth push is refused
        assert [ring.push(_msg(seq)) for seq in range(9)] == [True] * 8 + [
            False]
        # first in, first out across the wrap of the indices
        for seq in range(8):
            assert ring.pop().seq == seq
            assert ring.push(_msg(100 + seq))
        assert [ring.pop().seq for _ in range(8)] == list(range(100, 108))
    finally:
        ring.destroy()
    with pytest.raises(AssertionError):
        TTP.StateRing(6)


def _wait(fn, timeout=2.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got is not None:
            return got
        time.sleep(0.01)
    return None


def test_udp_state_flow_keeps_the_freshest():
    """State frames packed by the JAX package, sent over loopback, arrive
    at the port's link; a drain keeps only the latest."""
    rx = TTP.AutoboxLink(38811)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for seq in (1, 2, 3):
            s.sendto(JTP.pack_state(JFrom(**dataclasses.asdict(_msg(seq)))),
                     ("127.0.0.1", 38811))
        time.sleep(0.05)
        assert _wait(rx.recv_state) == _msg(3)
        assert rx.recv_state() is None
        # a frame of another size is dropped
        s.sendto(b"\0" * 10, ("127.0.0.1", 38811))
        time.sleep(0.05)
        assert rx.recv_state() is None
    finally:
        s.close()
        rx.close()


def test_udp_command_reaches_the_peer():
    """A command sent by the port's link arrives at its peer as the JAX
    package's frame of the same command; a link without a peer refuses
    to send."""
    peer = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    peer.bind(("127.0.0.1", 38822))
    peer.settimeout(2.0)
    link = TTP.AutoboxLink(38821, "127.0.0.1", 38822)
    lonely = TTP.AutoboxLink(38823)
    try:
        cmd = ToAutobox(**COMMANDS[0])
        assert link.send_cmd(cmd)
        buf, _ = peer.recvfrom(256)
        assert buf == JTP.pack_cmd(JTo(**COMMANDS[0]))
        assert TTP.unpack_cmd(buf) == cmd
        assert not lonely.send_cmd(cmd)
    finally:
        link.close()
        lonely.close()
        peer.close()
    link.close()                      # a second close is a no-op
