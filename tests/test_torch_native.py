"""The port's native runtime pieces (``native.py``: ``csrc/native_loader.cpp``
and ``csrc/native_channel.cpp``, built by g++ on first use) against the
cases of ``tests/test_native.py``, and the two packages' channels talking to
each other over loopback in one process.

Inputs are numpy from a seed.  Tolerances: decoded images exact (RGB to grey
within the reference's luminance bounds); every received tree equal to what
was sent, leaf by leaf and bit for bit.
"""

import dataclasses
import socket
import threading
from collections import namedtuple

import numpy as np
import pytest
import torch
from PIL import Image

from ccm_slam_tpu import native as jnative
from ccm_slam_tpu_torch import native
from ccm_slam_tpu_torch.io import synthetic
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import wire


Pair = namedtuple("Pair", "a b")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def exchange(server_cls, client_cls, payload, reply):
    """``client_cls`` connects to a ``server_cls`` listener, sends
    ``payload`` and receives ``reply``.  Returns (what the server got, what
    the client got)."""
    port = free_port()
    lfd = server_cls.listener(port)
    got = {}

    def serve():
        ch = server_cls.accept(lfd)
        got["msg"] = ch.recv()
        ch.send(reply)
        ch.close()

    th = threading.Thread(target=serve)
    th.start()
    cl = client_cls.connect("127.0.0.1", port)
    cl.send(payload)
    back = cl.recv()
    th.join(timeout=30)
    cl.close()
    socket.socket(fileno=lfd).close()
    assert not th.is_alive()
    return got["msg"], back


def assert_tree_equal(a, b):
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_tree_equal(x, y)
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_tree_equal(getattr(a, f.name), getattr(b, f.name))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def write_pngs(tmp_path, n=12, seed=0):
    rng = np.random.RandomState(seed)
    paths, truth = [], []
    for i in range(n):
        img = rng.randint(0, 255, (48, 64), dtype=np.uint8)
        p = str(tmp_path / f"f{i:03d}.png")
        Image.fromarray(img).save(p)
        paths.append(p)
        truth.append(img)
    return paths, truth


def test_loader_decodes_in_order(tmp_path):
    paths, truth = write_pngs(tmp_path)
    loader = native.NativeImageLoader(paths, n_threads=3, queue_depth=4)
    out = list(loader)
    loader.close()
    assert len(out) == 12
    for got, want in zip(out, truth):
        assert got.shape == (48, 64) and got.dtype == np.float32
        np.testing.assert_array_equal(got.astype(np.uint8), want)
    assert native.library_path("native_loader").is_file()


def test_loader_turns_rgb_grey(tmp_path):
    rgb = np.zeros((8, 8, 3), np.uint8)
    rgb[..., 0] = 200  # pure red
    p = str(tmp_path / "rgb.png")
    Image.fromarray(rgb).save(p)
    loader = native.NativeImageLoader([p])
    (img,) = list(loader)
    loader.close()
    assert img.shape == (8, 8)
    assert 30 < img[0, 0] < 90  # luminance of pure red ~ 0.3 * 200


def test_loader_reports_a_bad_file(tmp_path):
    p = tmp_path / "bad.png"
    p.write_bytes(b"not a png")
    loader = native.NativeImageLoader([str(p)])
    with pytest.raises(IOError):
        next(loader)
    loader.close()


def tree_payload():
    return {
        "kfs": torch.arange(10, dtype=torch.int32),
        "desc": np.zeros((4, 32), np.uint8),
        "nested": {"t": torch.ones(3), "list": [torch.tensor([1.5]), 7],
                   "pair": Pair(torch.zeros(2, 2, dtype=torch.bool), b"\x00\x01raw")},
        "packed": b"CCMW" + bytes(range(256)),
        "type": "map",
        "none": None,
    }


def test_tree_with_tensors_and_bytes_round_trips():
    payload = tree_payload()
    got, back = exchange(native.NativeChannel, native.NativeChannel, payload, {"ack": [1, 2]})
    assert isinstance(got["kfs"], np.ndarray) and got["kfs"].dtype == np.int32
    np.testing.assert_array_equal(got["kfs"], np.arange(10))
    assert got["packed"] == payload["packed"] and got["none"] is None
    assert type(got["nested"]["pair"]).__name__ == "Pair"
    assert got["nested"]["pair"].b == b"\x00\x01raw"
    assert_tree_equal(got, native._from_bytes(native._to_bytes(payload)))
    np.testing.assert_array_equal(back["ack"][0], 1)


def test_wire_packed_mapmsg_crosses_the_channel():
    world, wdesc = synthetic.make_world(np.random.RandomState(2), n=300)
    m = synthetic.build_agent_map(world, wdesc, synthetic.agent_corridor(0),
                                  synthetic.agent_gauge(0, "cpu"), device="cpu")
    st = comm.ClientCommState.create(m.kfs.capacity, m.mps.capacity)
    msg, st = comm.publish_client(m, st, 0, max_kfs=2, max_mps=400)
    packed = wire.pack_map_msg(msg)
    got, _ = exchange(native.NativeChannel, native.NativeChannel,
                      {"type": "map", "msg": packed}, {"type": "ack"})
    assert got["msg"] == packed
    rx = wire.unpack_map_msg(got["msg"], "cpu")
    assert torch.equal(rx.kfs.kf_id, msg.kfs.kf_id)
    assert int(rx.kfs.valid.sum()) == 2
    assert torch.equal(rx.mps.mp_id[rx.mps.valid], msg.mps.mp_id[msg.mps.valid])
    # a tree of dataclass batches crosses as it is
    got, _ = exchange(native.NativeChannel, native.NativeChannel,
                      {"kfs": msg.kfs, "msg_id": msg.msg_id}, {})
    assert isinstance(got["kfs"], comm.KFMsgBatch)
    np.testing.assert_array_equal(got["kfs"].kf_id, msg.kfs.kf_id.numpy())
    assert int(got["kfs"].valid.sum()) == 2


def test_jax_channel_sends_and_the_port_receives():
    import jax.numpy as jnp

    payload = {"kfs": jnp.arange(10, dtype=jnp.int32), "desc": np.zeros((4, 32), np.uint8),
               "nested": {"t": jnp.ones(3)}, "packed": b"\x01\x02", "type": "hello",
               "agent": 1, "none": None}
    reply = {"type": "ack", "msg": b"payload", "ids": torch.tensor([3, 4])}
    got, back = exchange(native.NativeChannel, jnative.NativeChannel, payload, reply)
    assert_tree_equal(got, jnative._from_bytes(jnative._to_bytes(payload)))
    assert_tree_equal(back, native._from_bytes(native._to_bytes(reply)))
    assert int(got["agent"]) == 1 and got["type"] == "hello"


def test_port_channel_sends_and_jax_receives():
    import jax.numpy as jnp

    payload = tree_payload()
    reply = {"ack": jnp.asarray([1, 2, 3]), "vicinity": None}
    got, back = exchange(jnative.NativeChannel, native.NativeChannel, payload, reply)
    assert_tree_equal(got, native._from_bytes(native._to_bytes(payload)))
    assert_tree_equal(back, jnative._from_bytes(jnative._to_bytes(reply)))
