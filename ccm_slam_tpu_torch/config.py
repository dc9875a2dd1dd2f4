"""The configuration the port reads so far: the port's own copy.

Same values as the reference's ``cslam/conf/config.yaml`` and
``conf/vi_euroc.yaml`` (ORB extractor budget, the EuRoC cam0 pinhole + radtan
calibration, the per-frame and client-map capacities).  Plain frozen
dataclasses; sections grow as later slices need them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ExtractorConfig:
    """ORB extraction budget (reference conf/config.yaml:38-51)."""

    n_features: int = 1000          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_th_fast: int = 20           # ORBextractor.iniThFAST
    min_th_fast: int = 7            # ORBextractor.minThFAST
    cell_size: int = 30             # FAST threshold-fallback cell (px)
    init_features_factor: int = 2   # initialization extractor budget (Tracking.cpp:75)


@dataclass(frozen=True)
class CameraConfig:
    """Pinhole + radtan calibration (reference conf/vi_euroc.yaml)."""

    width: int = 752
    height: int = 480
    fx: float = 458.654
    fy: float = 457.296
    cx: float = 367.215
    cy: float = 248.375
    k1: float = -0.28340811
    k2: float = 0.07395907
    p1: float = 0.00019359
    p2: float = 1.76187114e-05
    k3: float = 0.0
    fps: float = 20.0


@dataclass(frozen=True)
class CapacityConfig:
    """Fixed per-frame and client-map capacities read by the front-end."""

    max_keypoints: int = 1024          # per-frame feature slots (>= n_features)
    client_max_mps: int = 16384        # client landmark arena


def scaled_camera(base: Optional[CameraConfig] = None, factor: float = 0.5) -> CameraConfig:
    """The EuRoC camera at a reduced resolution: focal lengths and principal
    point scale with the pixel grid (pixel centres: u' = (u + 0.5) f - 0.5);
    the radtan coefficients act on normalized coordinates and stay."""
    base = base or CameraConfig()
    return dataclasses.replace(
        base,
        width=int(round(base.width * factor)),
        height=int(round(base.height * factor)),
        fx=base.fx * factor, fy=base.fy * factor,
        cx=(base.cx + 0.5) * factor - 0.5,
        cy=(base.cy + 0.5) * factor - 0.5,
    )
