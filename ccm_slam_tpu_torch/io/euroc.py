"""The frame type the port's sequences yield (the reference's ``EurocFrame``,
``ccm_slam_tpu/io/euroc.py``).  The EuRoC directory reader itself comes in a
later slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class EurocFrame:
    timestamp: float   # seconds
    image: np.ndarray  # [H,W] float32 grayscale 0..255
