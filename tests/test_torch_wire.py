"""The port's wire codec against the JAX package's (``runtime/wire.py``).

Messages come from ``publish_client`` of the JAX package on
``build_agent_map`` maps (the synthetic corridor of tests/test_map_matching.py)
and are carried into the port field by field (``msg_to_torch``); the port's
own ``publish_client`` on the converted map gives a second message (its
relative poses round differently in the last bit, so it is compared after
decoding, to 1e-5).  Bytes are compared, not decoded arrays: the port's
bytes equal JAX's for the same message (quaternion branch and sign, angle
and normal rounding included), JAX's ``unpack_map_msg`` reads the port's
bytes, and each package's decode of one byte string gives the same arrays
(exact).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.io.synthetic import build_agent_map, make_world
from ccm_slam_tpu.runtime import communicator as jcomm
from ccm_slam_tpu.runtime import wire as jwire
from ccm_slam_tpu.utils.lie import Sim3 as JSim3
from ccm_slam_tpu.utils.lie import so3_exp
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.runtime import communicator as comm
from ccm_slam_tpu_torch.runtime import wire


def batch_to_torch(jb, cls, device="cpu"):
    return None if jb is None else cls(**{
        f.name: torch.as_tensor(np.array(getattr(jb, f.name)), device=device)
        for f in dataclasses.fields(cls)})


def msg_to_torch(jmsg, device="cpu") -> comm.MapMsg:
    """A JAX MapMsg as the port's, field by field (same dtypes)."""
    return comm.MapMsg(
        kfs=batch_to_torch(jmsg.kfs, comm.KFMsgBatch, device),
        mps=batch_to_torch(jmsg.mps, comm.MPMsgBatch, device),
        ack_kf_ids=np.asarray(jmsg.ack_kf_ids), ack_mp_ids=np.asarray(jmsg.ack_mp_ids),
        weak_ack_kf_id=jmsg.weak_ack_kf_id, weak_ack_mp_id=jmsg.weak_ack_mp_id,
        closest_kf_id=jmsg.closest_kf_id, msg_id=jmsg.msg_id)


def assert_msgs_equal(ours, ref):
    """Every field of two MapMsgs (port, JAX) equal, dtypes included."""
    for name, cls in (("kfs", comm.KFMsgBatch), ("mps", comm.MPMsgBatch)):
        a, b = getattr(ours, name), getattr(ref, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        for f in dataclasses.fields(cls):
            x, y = getattr(a, f.name).cpu().numpy(), np.asarray(getattr(b, f.name))
            assert x.dtype == y.dtype, (name, f.name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f.name}")
    for f in ("ack_kf_ids", "ack_mp_ids"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    for f in ("weak_ack_kf_id", "weak_ack_mp_id", "closest_kf_id", "msg_id"):
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.fixture(scope="module")
def maps():
    rng = np.random.RandomState(3)
    world, wdesc = make_world(rng, n=300)
    gauge = JSim3(s=jnp.float32(1.3), R=so3_exp(jnp.array([0.02, -0.3, 0.1])),
                  t=jnp.array([0.2, -0.1, 0.4]))
    jm = build_agent_map(world, wdesc, [0.0, 1.0, 2.0, 3.0], gauge, kf_id_base=5, client_id=1)
    return jm, convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")


@pytest.fixture(scope="module")
def messages(maps):
    jm, m = maps
    jst = jcomm.ClientCommState.create(16, 1024)
    st = comm.ClientCommState.create(16, 1024)
    jmsg, jst = jcomm.publish_client(jm, jst, 1, max_kfs=6, max_mps=500, current_kf_id=7)
    msg, st = comm.publish_client(m, st, 1, max_kfs=6, max_mps=500, current_kf_id=7)
    return jmsg, msg


def test_pack_bytes_equal_jax(messages):
    jmsg, msg = messages
    jb = jwire.pack_map_msg(jmsg)
    assert wire.pack_map_msg(msg_to_torch(jmsg)) == jb
    # the port's own publish of the converted map: the same integers and
    # quantized fields, poses to 1e-5
    ours, ref = wire.unpack_map_msg(wire.pack_map_msg(msg), device="cpu"), jwire.unpack_map_msg(jb)
    for name, cls in (("kfs", comm.KFMsgBatch), ("mps", comm.MPMsgBatch)):
        for f in dataclasses.fields(cls):
            x = getattr(getattr(ours, name), f.name).numpy()
            y = np.asarray(getattr(getattr(ref, name), f.name))
            if x.dtype.kind == "f":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5, err_msg=f.name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_roundtrip_and_cross_decode(messages):
    jmsg, msg = messages
    data = wire.pack_map_msg(msg)
    ours = wire.unpack_map_msg(data, device="cpu")
    ref = jwire.unpack_map_msg(data)  # JAX reads the port's bytes
    assert_msgs_equal(ours, ref)
    # a decoded message re-encodes to the same bytes in both packages (a
    # quaternion's round trip may move its last bit, so not always to data)
    assert wire.pack_map_msg(ours) == jwire.pack_map_msg(ref)
    # the decode restores the padded shapes and the quantized payload
    assert ours.kfs.valid.shape == msg.kfs.valid.shape and ours.mps.obs_kf_id.shape == \
        msg.mps.obs_kf_id.shape
    kv = msg.kfs.valid.numpy()
    np.testing.assert_allclose(ours.kfs.R_cpred.numpy()[kv], msg.kfs.R_cpred.numpy()[kv],
                               atol=1e-5)
    fv = msg.kfs.feat_valid.numpy() & kv[:, None]
    np.testing.assert_array_equal(ours.kfs.desc.numpy()[fv], msg.kfs.desc.numpy()[fv])


def test_quaternion_branches_and_signs_match_jax():
    """Rotations that take each of Shepperd's four branches (trace near -1,
    180-degree turns about each axis, tiny and random angles)."""
    rng = np.random.RandomState(11)
    axes = np.concatenate([np.eye(3), rng.randn(20, 3)])
    angles = np.concatenate([np.full(3, np.pi), rng.uniform(-np.pi, np.pi, 17),
                             [1e-7, 3.1415, 0.0]])
    R = np.asarray(so3_exp(jnp.asarray(axes / np.linalg.norm(axes, axis=1, keepdims=True)
                                       * angles[:, None], jnp.float32)))
    B = R.shape[0]
    np.testing.assert_array_equal(wire._quat_from_R(R), jwire._quat_from_R(R))
    np.testing.assert_array_equal(wire._R_from_quat(wire._quat_from_R(R)),
                                  jwire._R_from_quat(jwire._quat_from_R(R)))
    # through whole messages: angles on the 2 pi seam, unnormalized normals
    jm_like = dict(
        valid=np.ones(B, bool), full=np.arange(B) % 2 == 0, kf_id=np.arange(B, dtype=np.int32),
        client_id=np.full(B, 3, np.int32), timestamp=rng.rand(B).astype(np.float32),
        R_cpred=R, t_cpred=rng.randn(B, 3).astype(np.float32),
        pred_kf_id=np.arange(B, dtype=np.int32) - 1, R_cpar=R[::-1].copy(),
        t_cpar=rng.randn(B, 3).astype(np.float32), par_kf_id=np.full(B, -1, np.int32),
        xy=rng.rand(B, 4, 2).astype(np.float32) * 700,
        desc=rng.randint(0, 256, (B, 4, 32)).astype(np.uint8),
        octave=rng.randint(0, 8, (B, 4)).astype(np.int32),
        angle=np.tile(np.array([0.0, 2 * np.pi - 1e-6, -0.01, 7.0], np.float32), (B, 1)),
        feat_valid=rng.rand(B, 4) < 0.7, mp_assoc_id=rng.randint(-1, 50, (B, 4)).astype(np.int32))
    mp_like = dict(
        valid=np.ones(5, bool), full=np.ones(5, bool), mp_id=np.arange(5, dtype=np.int32),
        client_id=np.full(5, 3, np.int32), pos_ref=rng.randn(5, 3).astype(np.float32),
        ref_kf_id=np.arange(5, dtype=np.int32), ref_client_id=np.full(5, 3, np.int32),
        desc=rng.randint(0, 256, (5, 32)).astype(np.uint8),
        normal_ref=(rng.randn(5, 3) * 3).astype(np.float32),
        min_dist=rng.rand(5).astype(np.float32), max_dist=rng.rand(5).astype(np.float32) + 1,
        obs_kf_id=rng.randint(0, 9, (5, 3)).astype(np.int32),
        obs_feat=rng.randint(0, 1000, (5, 3)).astype(np.int32), obs_valid=rng.rand(5, 3) < 0.6)
    jmsg = jcomm.MapMsg(kfs=jcomm.KFMsgBatch(**{k: jnp.asarray(v) for k, v in jm_like.items()}),
                        mps=jcomm.MPMsgBatch(**{k: jnp.asarray(v) for k, v in mp_like.items()}),
                        ack_kf_ids=np.array([3, 9], np.int64), ack_mp_ids=np.zeros(0, np.int64),
                        weak_ack_kf_id=4, weak_ack_mp_id=-1, closest_kf_id=2, msg_id=17)
    assert wire.pack_map_msg(msg_to_torch(jmsg)) == jwire.pack_map_msg(jmsg)


def test_ack_and_empty_messages_match_jax(messages):
    """The server's ack message (zero-row batches) and a vicinity message
    without batches (``kfs=None``)."""
    jmsg, _ = messages
    jack = jcomm.MapMsg(kfs=jax.tree.map(lambda x: x[:0], jmsg.kfs),
                        mps=jax.tree.map(lambda x: x[:0], jmsg.mps),
                        ack_kf_ids=np.array([5, 6, 8], np.int64),
                        ack_mp_ids=np.arange(7, dtype=np.int64), weak_ack_kf_id=-1,
                        weak_ack_mp_id=12)
    data = jwire.pack_map_msg(jack)
    assert wire.pack_map_msg(msg_to_torch(jack)) == data
    ours = wire.unpack_map_msg(data, device="cpu")
    assert ours.kfs is None and ours.mps is None  # zero-row batches decode to None
    np.testing.assert_array_equal(ours.ack_mp_ids, np.arange(7))
    none = comm.MapMsg(kfs=None, mps=None, ack_kf_ids=np.zeros(0, np.int64),
                       ack_mp_ids=np.zeros(0, np.int64))
    jnone = jcomm.MapMsg(kfs=None, mps=None, ack_kf_ids=np.zeros(0, np.int64),
                         ack_mp_ids=np.zeros(0, np.int64))
    assert wire.pack_map_msg(none) == jwire.pack_map_msg(jnone)
    with pytest.raises(ValueError):
        wire.unpack_map_msg(b"XXXX" + data[4:], device="cpu")
