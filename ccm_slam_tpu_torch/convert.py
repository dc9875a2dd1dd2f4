"""Moving BA problems and LM state into the port as tensors.

``ba_problem_fields`` reads the 13 ``BAProblem`` attributes of any object
(duck-typed, so this module needs nothing of the JAX package) as numpy
arrays; ``ba_problem_from_numpy`` builds the port's ``BAProblem`` from such a
mapping.  ``lm_state_from_numpy`` / ``lm_state_to_numpy`` do the same for
the ``(lam, dc, cost)`` triple that ``ba_solve(..., return_state=True)``
returns, so an interrupted solve can continue in either package.
``features_from_numpy`` / ``frame_from_numpy`` carry ORB features and frames
across the same way (``feature_fields`` / ``frame_fields`` read them), so
both packages' matching and geometry can run on identical inputs.
``map_state_fields`` / ``map_state_from_numpy`` / ``map_state_to_numpy`` do
it for a whole ``MapState`` (every arena field, the cursors), and
``system_config_from`` copies a configuration tree field by field.  The loop
closer's state crosses the same way: ``sim3_from_numpy``,
``vocabulary_from_numpy``, ``keyframe_db_from_numpy`` and
``pose_graph_problem_from_numpy`` (each with its ``*_fields`` reader).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from . import config as _config
from .device import resolve_device
from .models import keyframe_db as kdb
from .models import map_store as ms
from .ops.bow import Vocabulary
from .ops.orb import FrameFeatures
from .runtime.frame import Frame
from .solvers.ba import BAProblem
from .solvers.pose_graph import PoseGraphProblem
from .utils.lie import Sim3

BA_FIELDS = (
    "R", "t", "X", "cam_idx", "uv", "sigma2", "obs_valid", "cam_fixed",
    "point_valid", "fx", "fy", "cx", "cy",
)
_DTYPES = {
    "cam_idx": torch.int32,
    "obs_valid": torch.bool,
    "cam_fixed": torch.bool,
    "point_valid": torch.bool,
}


def ba_problem_fields(obj) -> dict[str, np.ndarray]:
    """The 13 BAProblem fields of ``obj`` as numpy arrays."""
    return {name: np.asarray(getattr(obj, name)) for name in BA_FIELDS}


def ba_problem_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> BAProblem:
    """The port's BAProblem on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    missing = [name for name in BA_FIELDS if name not in fields]
    if missing:
        raise KeyError(f"missing BAProblem fields: {missing}")
    tensors = {
        name: torch.tensor(np.asarray(fields[name]))
        .to(device=dev, dtype=_DTYPES.get(name, torch.float32))
        .contiguous()
        for name in BA_FIELDS
    }
    return BAProblem(**tensors)


def lm_state_from_numpy(state, device=None):
    """(lam, dc [C,6], cost) as float32 tensors on ``device``."""
    dev = resolve_device(device)
    return tuple(
        torch.tensor(np.asarray(x, np.float32)).to(dev).contiguous() for x in state
    )


def lm_state_to_numpy(state):
    return tuple(np.asarray(x.detach().cpu()) for x in state)


FEATURE_FIELDS = ("xy", "response", "octave", "angle", "desc", "valid")
FRAME_FIELDS = ("timestamp", "xy", "desc", "octave", "angle", "sigma2", "valid", "R_cw",
                "t_cw", "mp")
_FEATURE_DTYPES = {
    "octave": torch.int32,
    "desc": torch.uint8,
    "valid": torch.bool,
    "mp": torch.int32,
}


def _tensors(fields: Mapping[str, np.ndarray], names, device):
    dev = resolve_device(device)
    missing = [name for name in names if name not in fields]
    if missing:
        raise KeyError(f"missing fields: {missing}")
    return {
        name: torch.tensor(np.asarray(fields[name]))
        .to(device=dev, dtype=_FEATURE_DTYPES.get(name, torch.float32))
        .contiguous()
        for name in names
    }


def feature_fields(obj) -> dict[str, np.ndarray]:
    """The FrameFeatures fields of ``obj`` (either package's) as numpy arrays."""
    return {name: np.asarray(getattr(obj, name)) for name in FEATURE_FIELDS}


def frame_fields(obj) -> dict[str, np.ndarray]:
    """The Frame fields of ``obj`` (either package's) as numpy arrays."""
    return {name: np.asarray(getattr(obj, name)) for name in FRAME_FIELDS}


def features_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> FrameFeatures:
    """The port's FrameFeatures on ``device`` (the card unless told otherwise)."""
    return FrameFeatures(**_tensors(fields, FEATURE_FIELDS, device))


def frame_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Frame:
    """The port's Frame on ``device`` (the card unless told otherwise)."""
    return Frame(**_tensors(fields, FRAME_FIELDS, device))


_KF_FIELDS = tuple(f.name for f in dataclasses.fields(ms.KeyFrameStore))
_MP_FIELDS = tuple(f.name for f in dataclasses.fields(ms.MapPointStore))
_CURSORS = ("next_kf", "next_mp", "insert_counter")


def map_state_fields(obj) -> dict:
    """Every field of a MapState (either package's) as numpy arrays:
    {"kfs": {...}, "mps": {...}, "next_kf", "next_mp", "insert_counter"}."""
    out = {"kfs": {n: np.asarray(getattr(obj.kfs, n)) for n in _KF_FIELDS},
           "mps": {n: np.asarray(getattr(obj.mps, n)) for n in _MP_FIELDS}}
    out.update({n: np.asarray(getattr(obj, n)) for n in _CURSORS})
    return out


def map_state_from_numpy(fields: Mapping, device=None) -> ms.MapState:
    """The port's MapState on ``device`` (the card unless told otherwise),
    each tensor with its array's dtype; cursors as 0-d int32."""
    dev = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    return ms.MapState(
        kfs=ms.KeyFrameStore(**{n: t(fields["kfs"][n]) for n in _KF_FIELDS}),
        mps=ms.MapPointStore(**{n: t(fields["mps"][n]) for n in _MP_FIELDS}),
        **{n: torch.tensor(int(fields[n]), dtype=torch.int32, device=dev) for n in _CURSORS},
    )


def map_state_to_numpy(m: ms.MapState) -> dict:
    """``map_state_fields`` of the port's MapState (copied to the host)."""
    def h(x):
        return np.asarray(x.detach().cpu())

    out = {"kfs": {n: h(getattr(m.kfs, n)) for n in _KF_FIELDS},
           "mps": {n: h(getattr(m.mps, n)) for n in _MP_FIELDS}}
    out.update({n: h(getattr(m, n)) for n in _CURSORS})
    return out


def system_config_from(obj) -> _config.SystemConfig:
    """The port's SystemConfig with every field read from ``obj`` (any
    configuration tree with the same sections and names, e.g. the JAX
    package's), section by section."""
    sections = {}
    for f in dataclasses.fields(_config.SystemConfig):
        val = getattr(obj, f.name)
        if dataclasses.is_dataclass(val):
            cls = type(getattr(_config.DEFAULT_CONFIG, f.name))
            val = cls(**{g.name: getattr(val, g.name) for g in dataclasses.fields(cls)})
        sections[f.name] = val
    return _config.SystemConfig(**sections)


def _as(fields: Mapping, dev, **dtypes) -> dict:
    return {name: torch.as_tensor(np.array(fields[name])).to(dev, dtype)
            for name, dtype in dtypes.items()}


def sim3_fields(obj) -> dict[str, np.ndarray]:
    """s, R, t of a (batched) Sim3 of either package as numpy arrays."""
    return {name: np.asarray(getattr(obj, name)) for name in ("s", "R", "t")}


def sim3_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Sim3:
    """The port's Sim3 (float32) on ``device`` (the card unless told otherwise)."""
    f32 = torch.float32
    return Sim3(**_as(fields, resolve_device(device), s=f32, R=f32, t=f32))


def vocabulary_fields(obj) -> dict[str, np.ndarray]:
    return {name: np.asarray(getattr(obj, name)) for name in ("words", "idf")}


def vocabulary_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> Vocabulary:
    """The port's Vocabulary (uint8 words, float32 idf) on ``device``."""
    return Vocabulary(**_as(fields, resolve_device(device), words=torch.uint8,
                            idf=torch.float32))


def keyframe_db_fields(obj) -> dict[str, np.ndarray]:
    return {name: np.asarray(getattr(obj, name)) for name in ("vectors", "valid", "map_id")}


def keyframe_db_from_numpy(fields: Mapping[str, np.ndarray], device=None) -> kdb.KeyFrameDB:
    """The port's KeyFrameDB on ``device`` (the card unless told otherwise)."""
    return kdb.KeyFrameDB(**_as(fields, resolve_device(device), vectors=torch.float32,
                                valid=torch.bool, map_id=torch.int32))


_PG_ARRAYS = dict(fixed=torch.bool, vert_valid=torch.bool, i_idx=torch.int32,
                  j_idx=torch.int32, edge_valid=torch.bool, weight=torch.float32)


def pose_graph_problem_fields(obj) -> dict:
    """Every field of a PoseGraphProblem (either package's) as numpy arrays;
    its two Sim3s as ``sim3_fields`` dicts."""
    out = {name: np.asarray(getattr(obj, name)) for name in _PG_ARRAYS}
    out.update(S_w=sim3_fields(obj.S_w), S_meas=sim3_fields(obj.S_meas))
    return out


def pose_graph_problem_from_numpy(fields: Mapping, device=None) -> PoseGraphProblem:
    """The port's PoseGraphProblem on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    return PoseGraphProblem(S_w=sim3_from_numpy(fields["S_w"], dev),
                            S_meas=sim3_from_numpy(fields["S_meas"], dev),
                            **_as(fields, dev, **_PG_ARRAYS))
