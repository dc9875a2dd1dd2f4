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
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .device import resolve_device
from .ops.orb import FrameFeatures
from .runtime.frame import Frame
from .solvers.ba import BAProblem

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
