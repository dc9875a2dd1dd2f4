"""Compact wire codec for MapMsg (numpy; the port's own copy of
``ccm_slam_tpu/runtime/wire.py``).

The reference quantizes its wire schema (cslam_msgs/msg/KF.msg, MP.msg);
the port's MapMsg is a set of fixed-capacity padded tensors.  The codec:

* drops padded rows (only valid keyframes, landmarks and features ship);
* sends poses as quaternion + translation (7 f32);
* per feature: xy f32[2], octave u8, angle u8 (1.4 deg), the 32-byte
  descriptor and the i32 landmark id;
* landmark normals as i8[3] unit vectors; observations as (i32 kf id, u16
  feature) pairs.

``pack_map_msg`` gives the reference's bytes for the same message (same
header, field order, quaternion branch and rounding), so either package
can decode the other's messages.  ``unpack_map_msg`` restores the original
padded shapes as tensors on a device (the card unless told otherwise).
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

from ..device import resolve_device
from .communicator import KFMsgBatch, MapMsg, MPMsgBatch

MAGIC = b"CCMW"
VERSION = 2
_HEADER = "<4sBiiiiiiiiqq"
_TAIL = "<qi"


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Batched rotation matrix -> unit quaternion (w,x,y,z): Shepperd's
    construction, the best-conditioned of four per row."""
    R = np.asarray(R, np.float64)
    B = R.shape[0]
    q = np.zeros((B, 4), np.float64)
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    cand = np.stack([
        1.0 + tr,
        1.0 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
        1.0 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2],
        1.0 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2],
    ], 1)
    best = np.argmax(cand, axis=1)
    s = np.sqrt(np.clip(cand[np.arange(B), best], 1e-12, None)) * 2.0
    for b in range(B):
        i, Rb = best[b], R[b]
        if i == 0:
            q[b] = [s[b] / 4, (Rb[2, 1] - Rb[1, 2]) / s[b],
                    (Rb[0, 2] - Rb[2, 0]) / s[b], (Rb[1, 0] - Rb[0, 1]) / s[b]]
        elif i == 1:
            q[b] = [(Rb[2, 1] - Rb[1, 2]) / s[b], s[b] / 4,
                    (Rb[0, 1] + Rb[1, 0]) / s[b], (Rb[0, 2] + Rb[2, 0]) / s[b]]
        elif i == 2:
            q[b] = [(Rb[0, 2] - Rb[2, 0]) / s[b], (Rb[0, 1] + Rb[1, 0]) / s[b],
                    s[b] / 4, (Rb[1, 2] + Rb[2, 1]) / s[b]]
        else:
            q[b] = [(Rb[1, 0] - Rb[0, 1]) / s[b], (Rb[0, 2] + Rb[2, 0]) / s[b],
                    (Rb[1, 2] + Rb[2, 1]) / s[b], s[b] / 4]
    q /= np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-12, None)
    return q.astype(np.float32)


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    q = np.asarray(q, np.float64)
    q = q / np.clip(np.linalg.norm(q, axis=1, keepdims=True), 1e-12, None)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    return R.astype(np.float32)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _wa(buf: io.BytesIO, arr, dtype):
    buf.write(np.ascontiguousarray(np.asarray(arr), dtype).tobytes())


def pack_map_msg(msg: MapMsg) -> bytes:
    """MapMsg -> compact bytes (each batch copied to the host once)."""
    kfb = None if msg.kfs is None else {f: _np(getattr(msg.kfs, f))
                                        for f in KFMsgBatch.__dataclass_fields__}
    mpb = None if msg.mps is None else {f: _np(getattr(msg.mps, f))
                                        for f in MPMsgBatch.__dataclass_fields__}
    buf = io.BytesIO()
    kv = kfb["valid"] if kfb is not None else np.zeros(0, bool)
    mv = mpb["valid"] if mpb is not None else np.zeros(0, bool)
    ksel, msel = np.where(kv)[0], np.where(mv)[0]
    N = int(kfb["xy"].shape[1]) if kfb is not None else 0
    O = int(mpb["obs_kf_id"].shape[1]) if mpb is not None else 0
    ack_kf = np.asarray(msg.ack_kf_ids, np.int64)
    ack_mp = np.asarray(msg.ack_mp_ids, np.int64)
    buf.write(struct.pack(_HEADER, MAGIC, VERSION, int(kv.shape[0]), int(mv.shape[0]), N, O,
                          len(ksel), len(msel), len(ack_kf), len(ack_mp),
                          int(msg.weak_ack_kf_id), int(msg.weak_ack_mp_id)))
    buf.write(struct.pack(_TAIL, int(msg.closest_kf_id), int(msg.msg_id)))
    _wa(buf, ack_kf, np.int64)
    _wa(buf, ack_mp, np.int64)

    if len(ksel):
        k = {f: v[ksel] for f, v in kfb.items()}
        _wa(buf, ksel, np.int32)
        _wa(buf, k["full"], np.uint8)
        _wa(buf, k["kf_id"], np.int32)
        _wa(buf, k["client_id"], np.uint8)
        _wa(buf, k["timestamp"], np.float64)
        _wa(buf, _quat_from_R(k["R_cpred"]), np.float32)
        _wa(buf, k["t_cpred"], np.float32)
        _wa(buf, k["pred_kf_id"], np.int32)
        _wa(buf, _quat_from_R(k["R_cpar"]), np.float32)
        _wa(buf, k["t_cpar"], np.float32)
        _wa(buf, k["par_kf_id"], np.int32)
        fv = k["feat_valid"]                                  # [S,N]
        _wa(buf, fv.sum(axis=1).astype(np.int32), np.int32)
        flat = fv.reshape(-1)
        _wa(buf, np.where(flat)[0].astype(np.int32), np.int32)
        _wa(buf, k["xy"].reshape(-1, 2)[flat], np.float32)
        _wa(buf, np.clip(k["octave"].reshape(-1)[flat], 0, 255), np.uint8)
        ang = k["angle"].reshape(-1)[flat]
        _wa(buf, np.round((ang % (2 * np.pi)) * (256.0 / (2 * np.pi))) % 256, np.uint8)
        _wa(buf, k["desc"].reshape(-1, 32)[flat], np.uint8)
        _wa(buf, k["mp_assoc_id"].reshape(-1)[flat], np.int32)

    if len(msel):
        p = {f: v[msel] for f, v in mpb.items()}
        _wa(buf, msel, np.int32)
        _wa(buf, p["full"], np.uint8)
        _wa(buf, p["mp_id"], np.int32)
        _wa(buf, p["client_id"], np.uint8)
        _wa(buf, p["pos_ref"], np.float32)
        _wa(buf, p["ref_kf_id"], np.int32)
        _wa(buf, p["ref_client_id"], np.uint8)
        _wa(buf, p["desc"], np.uint8)
        nrm = p["normal_ref"]
        nrm = nrm / np.clip(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9, None)
        _wa(buf, np.round(nrm * 127.0), np.int8)
        _wa(buf, p["min_dist"], np.float32)
        _wa(buf, p["max_dist"], np.float32)
        ov = p["obs_valid"]                                   # [S,O]
        _wa(buf, ov.sum(axis=1).astype(np.int32), np.int32)
        oflat = ov.reshape(-1)
        _wa(buf, p["obs_kf_id"].reshape(-1)[oflat], np.int32)
        _wa(buf, p["obs_feat"].reshape(-1)[oflat], np.uint16)
    return buf.getvalue()


class _Reader:
    def __init__(self, data: bytes, off: int):
        self.d = data
        self.o = off

    def arr(self, dtype, shape):
        n = int(np.prod(shape)) if shape else 1
        a = np.frombuffer(self.d, dtype, count=n, offset=self.o)
        self.o += a.nbytes
        return a.reshape(shape)


def unpack_map_msg(data: bytes, device=None) -> MapMsg:
    """bytes -> MapMsg with the original padded shapes, as tensors on
    ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    hdr = struct.unpack_from(_HEADER, data, 0)
    if hdr[0] != MAGIC or hdr[1] != VERSION:
        raise ValueError("bad wire message")
    Bk, Bm, N, O, nk, nm, nack_k, nack_m, weak_kf, weak_mp = hdr[2:]
    off = struct.calcsize(_HEADER)
    closest, msg_id = struct.unpack_from(_TAIL, data, off)
    r = _Reader(data, off + struct.calcsize(_TAIL))
    ack_kf = r.arr(np.int64, (nack_k,))
    ack_mp = r.arr(np.int64, (nack_m,))

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    kfb = None
    if Bk:
        a = dict(valid=np.zeros(Bk, bool), full=np.zeros(Bk, bool),
                 kf_id=np.zeros(Bk, np.int32), client_id=np.zeros(Bk, np.int32),
                 timestamp=np.zeros(Bk, np.float64),
                 R_cpred=np.tile(np.eye(3, dtype=np.float32), (Bk, 1, 1)),
                 t_cpred=np.zeros((Bk, 3), np.float32), pred_kf_id=np.full(Bk, -1, np.int32),
                 R_cpar=np.tile(np.eye(3, dtype=np.float32), (Bk, 1, 1)),
                 t_cpar=np.zeros((Bk, 3), np.float32), par_kf_id=np.full(Bk, -1, np.int32),
                 xy=np.zeros((Bk, N, 2), np.float32), desc=np.zeros((Bk, N, 32), np.uint8),
                 octave=np.zeros((Bk, N), np.int32), angle=np.zeros((Bk, N), np.float32),
                 feat_valid=np.zeros((Bk, N), bool), mp_assoc_id=np.full((Bk, N), -1, np.int32))
        if nk:
            ksel = r.arr(np.int32, (nk,))
            a["valid"][ksel] = True
            a["full"][ksel] = r.arr(np.uint8, (nk,)).astype(bool)
            a["kf_id"][ksel] = r.arr(np.int32, (nk,))
            a["client_id"][ksel] = r.arr(np.uint8, (nk,))
            a["timestamp"][ksel] = r.arr(np.float64, (nk,))
            a["R_cpred"][ksel] = _R_from_quat(r.arr(np.float32, (nk, 4)))
            a["t_cpred"][ksel] = r.arr(np.float32, (nk, 3))
            a["pred_kf_id"][ksel] = r.arr(np.int32, (nk,))
            a["R_cpar"][ksel] = _R_from_quat(r.arr(np.float32, (nk, 4)))
            a["t_cpar"][ksel] = r.arr(np.float32, (nk, 3))
            a["par_kf_id"][ksel] = r.arr(np.int32, (nk,))
            total = int(r.arr(np.int32, (nk,)).sum())
            lanes = r.arr(np.int32, (total,))      # flat [S*N] feature indices
            gk, gf = ksel[lanes // N], lanes % N
            a["feat_valid"][gk, gf] = True
            a["xy"][gk, gf] = r.arr(np.float32, (total, 2))
            a["octave"][gk, gf] = r.arr(np.uint8, (total,))
            a["angle"][gk, gf] = r.arr(np.uint8, (total,)).astype(np.float32) * (
                2 * np.pi / 256.0)
            a["desc"][gk, gf] = r.arr(np.uint8, (total, 32))
            a["mp_assoc_id"][gk, gf] = r.arr(np.int32, (total,))
        a["timestamp"] = a["timestamp"].astype(np.float32)
        kfb = KFMsgBatch(**{f: t(v) for f, v in a.items()})

    mpb = None
    if Bm:
        a = dict(valid=np.zeros(Bm, bool), full=np.zeros(Bm, bool),
                 mp_id=np.zeros(Bm, np.int32), client_id=np.zeros(Bm, np.int32),
                 pos_ref=np.zeros((Bm, 3), np.float32), ref_kf_id=np.full(Bm, -1, np.int32),
                 ref_client_id=np.zeros(Bm, np.int32), desc=np.zeros((Bm, 32), np.uint8),
                 normal_ref=np.zeros((Bm, 3), np.float32), min_dist=np.zeros(Bm, np.float32),
                 max_dist=np.zeros(Bm, np.float32), obs_kf_id=np.full((Bm, O), -1, np.int32),
                 obs_feat=np.zeros((Bm, O), np.int32), obs_valid=np.zeros((Bm, O), bool))
        if nm:
            msel = r.arr(np.int32, (nm,))
            a["valid"][msel] = True
            a["full"][msel] = r.arr(np.uint8, (nm,)).astype(bool)
            a["mp_id"][msel] = r.arr(np.int32, (nm,))
            a["client_id"][msel] = r.arr(np.uint8, (nm,))
            a["pos_ref"][msel] = r.arr(np.float32, (nm, 3))
            a["ref_kf_id"][msel] = r.arr(np.int32, (nm,))
            a["ref_client_id"][msel] = r.arr(np.uint8, (nm,))
            a["desc"][msel] = r.arr(np.uint8, (nm, 32))
            q = r.arr(np.int8, (nm, 3)).astype(np.float32) / 127.0
            a["normal_ref"][msel] = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True),
                                                1e-9, None)
            a["min_dist"][msel] = r.arr(np.float32, (nm,))
            a["max_dist"][msel] = r.arr(np.float32, (nm,))
            ocnt = r.arr(np.int32, (nm,))
            ot = int(ocnt.sum())
            orow = np.repeat(np.arange(nm), ocnt)
            oslot = (np.concatenate([np.arange(c) for c in ocnt]) if ot
                     else np.zeros(0, np.int64))
            gk = msel[orow]
            a["obs_valid"][gk, oslot] = True
            a["obs_kf_id"][gk, oslot] = r.arr(np.int32, (ot,))
            a["obs_feat"][gk, oslot] = r.arr(np.uint16, (ot,))
        mpb = MPMsgBatch(**{f: t(v) for f, v in a.items()})

    return MapMsg(kfs=kfb, mps=mpb, ack_kf_ids=ack_kf, ack_mp_ids=ack_mp,
                  weak_ack_kf_id=int(weak_kf), weak_ack_mp_id=int(weak_mp),
                  closest_kf_id=int(closest), msg_id=int(msg_id))
