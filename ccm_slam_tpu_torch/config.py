"""The configuration tree: the port's own copy of ``ccm_slam_tpu/config.py``.

Same sections and values as the reference's ``cslam/conf/config.yaml`` and
``conf/vi_euroc.yaml`` (``params::{extractor,tracking,mapping,comm,placerec,
opt}``, the EuRoC cam0 pinhole + radtan calibration) plus the fixed arena
capacities of the data model.  Plain frozen dataclasses threaded explicitly
through the pipeline.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
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
    grid_cols: int = 75             # feature grid for windowed search (Frame.h:116)
    grid_rows: int = 48
    patch_size: int = 31            # BRIEF patch
    half_patch: int = 15            # IC-angle radius
    init_features_factor: int = 2   # initialization extractor budget (Tracking.cpp:75)


@dataclass(frozen=True)
class TrackingConfig:
    """KF decision + per-function inlier gates (config.yaml:55-72)."""

    init_kfs: int = 5                      # reset if lost before this many KFs
    min_frames: int = 0                    # Tracking.MinFrames
    max_frames: int = 20                   # Tracking.MaxFrames
    matches_inliers_thres: int = 15        # Tracking.nMatchesInliersThres
    th_ref_ratio: float = 0.9              # Tracking.thRefRatio
    ref_kf_inlier_thres_search: int = 15
    ref_kf_inlier_thres_opt: int = 10
    motion_model_inlier_thres_search: int = 20
    motion_model_inlier_thres_opt: int = 10
    local_map_inlier_thres: int = 30
    mm_retry_window: float = 2.0           # widened motion-model retry (Tracking.cpp:578)


@dataclass(frozen=True)
class MappingConfig:
    """Client local-map bounds + culling (config.yaml:78-81)."""

    local_map_size: int = 50       # Mapping.LocalMapSize
    local_map_buffer: int = 20     # Mapping.LocalMapBuffer
    recent_kf_window: int = 20     # Mapping.RecentKFWindow
    red_thres: float = 0.98        # Mapping.RedThres (KF redundancy culling)
    second_fuse_pass: bool = True  # re-fuse on the refined geometry + a short BA
    local_ba_max_cams: int = 40    # windowed local-BA caps (truncations surfaced)
    local_ba_max_points: int = 4096


@dataclass(frozen=True)
class CommConfig:
    """Client<->server exchange budgets (config.yaml:86-107)."""

    client_pub_freq: float = 5.0
    client_kf_it_bound: int = 30
    client_mp_it_bound: int = 3000
    client_pub_max_kfs: int = 40
    client_pub_max_mps: int = 2500
    server_pub_freq: float = 1.0
    server_kfs_to_client: int = 0
    server_kf_it_bound: int = 400
    server_mp_it_bound: int = 12000


@dataclass(frozen=True)
class PlaceRecConfig:
    """Loop/map-match thresholds (config.yaml:112-117 + Opt block)."""

    new_loop_thres: int = 20
    start_map_matching_after_kf: int = 30
    covisibility_consistency_th: int = 3
    matches_thres: int = 20
    inliers_thres: int = 20
    total_matches_thres: int = 40
    probability: float = 0.99
    min_inliers: int = 6
    max_iterations: int = 300


@dataclass(frozen=True)
class OptConfig:
    """Optimizer iteration budgets (config.yaml:121-130)."""

    solver_iterations: int = 5
    gba_iterations: int = 20
    ess_graph_min_feats: int = 100
    pose_opt_rounds: int = 4       # pose-only BA: 4 rounds x 10 iterations
    pose_opt_its_per_round: int = 10
    chi2_mono: float = 5.991
    huber_delta_mono: float = 2.447651936
    huber_delta_sim3: float = 3.1622776601683795


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
    # T_SC: body(IMU)->camera transform, row-major 4x4 (vi_euroc.yaml Cam0.T*)
    t_sc: tuple = (
        (0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975),
        (0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768),
        (-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949),
        (0.0, 0.0, 0.0, 1.0),
    )


@dataclass(frozen=True)
class CapacityConfig:
    """Static arena bounds of the fixed-shape data model."""

    max_keypoints: int = 1024          # per-frame feature slots (>= n_features)
    client_max_kfs: int = 128          # >= LocalMapSize + LocalMapBuffer + margin
    client_max_mps: int = 16384        # client landmark arena
    server_max_kfs: int = 1024
    server_max_mps: int = 131072
    max_obs_per_mp: int = 32           # observation slots per landmark
    covis_neighbors: int = 32
    kf_id_space: int = 1 << 16
    mp_id_space: int = 1 << 20


@dataclass(frozen=True)
class SystemConfig:
    """Top-level assembly: one per deployment."""

    n_agents: int = 1
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    comm: CommConfig = field(default_factory=CommConfig)
    placerec: PlaceRecConfig = field(default_factory=PlaceRecConfig)
    opt: OptConfig = field(default_factory=OptConfig)
    camera: CameraConfig = field(default_factory=CameraConfig)
    capacity: CapacityConfig = field(default_factory=CapacityConfig)

    def replace(self, **kw) -> "SystemConfig":
        return dataclasses.replace(self, **kw)


DEFAULT_CONFIG = SystemConfig()

# KITTI odometry cam0 (reference conf/kitti_mono.yaml: rectified grayscale,
# no distortion, 10 fps, identity T_SC)
KITTI_CAMERA = CameraConfig(
    width=1241, height=376,
    fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
    k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
    fps=10.0,
    t_sc=((1.0, 0.0, 0.0, 0.0), (0.0, 1.0, 0.0, 0.0),
          (0.0, 0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0)),
)


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


def rendered_ci_config(factor: float = 0.4) -> SystemConfig:
    """The rendered-pixels configuration: at factor >= 0.7 the reference
    extractor budget (1000 features, 8 levels, 30 px cells) and 1,024 slots,
    24,576 landmark slots, K=16 observation slots; reduced resolutions keep a
    proportional budget.  MinFrames=2 rate-limits keyframes; no second fuse
    pass."""
    full = factor >= 0.7
    return SystemConfig(
        extractor=(ExtractorConfig() if full
                   else ExtractorConfig(n_features=400, n_levels=5, cell_size=16)),
        camera=scaled_camera(factor=factor),
        tracking=TrackingConfig(min_frames=2),
        mapping=MappingConfig(second_fuse_pass=False, red_thres=0.92),
        capacity=CapacityConfig(
            max_keypoints=1024 if full else 512,
            client_max_kfs=160,
            client_max_mps=24576 if full else 14336,
            server_max_kfs=256,
            server_max_mps=32768 if full else 24576,
            max_obs_per_mp=16,
            covis_neighbors=16,
        ),
    )


def tiny_test_config() -> SystemConfig:
    """Small-capacity config for fast unit tests."""
    return SystemConfig(
        extractor=ExtractorConfig(n_features=128, n_levels=4),
        capacity=CapacityConfig(
            max_keypoints=128,
            client_max_kfs=16,
            client_max_mps=512,
            server_max_kfs=32,
            server_max_mps=1024,
            max_obs_per_mp=8,
            covis_neighbors=8,
        ),
    )


def show_params(cfg: SystemConfig = None, file=None) -> str:
    """The whole parameter tree as text (the reference's ``params::ShowParams``
    start-up dump, cslam/src/config.cpp), one ``[section]`` per part of the
    configuration and one ``name = value`` line per field (4x4 matrices
    shown as ``<4x4 matrix>``).  Returns the string; also prints it to
    ``file`` when given (e.g. sys.stdout)."""
    cfg = cfg or DEFAULT_CONFIG
    lines = ["ccm_slam_tpu_torch parameters"]
    for section_name in (
        "system", "extractor", "tracking", "mapping", "comm", "placerec",
        "opt", "capacity", "camera",
    ):
        section = getattr(cfg, section_name, None)
        if section is None:
            continue
        lines.append(f"[{section_name}]")
        for f in dataclasses.fields(section):
            v = getattr(section, f.name)
            if isinstance(v, tuple) and v and isinstance(v[0], tuple):
                v = "<4x4 matrix>"
            lines.append(f"  {f.name} = {v}")
    out = "\n".join(lines)
    if file is not None:
        print(out, file=file)
    return out
