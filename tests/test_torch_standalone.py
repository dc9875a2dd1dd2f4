"""The port's StandaloneSystem end to end on the CPU: the synthetic loop
circuit of tests/test_standalone_loop.py (``circuit_trajectory``,
``make_circuit_world``, ``render_circuit_frame``, ``_loop_cfg(4)``: 230
frames, 256 feature slots, 4 octaves, 512 words), each frame handed to the
port as arrays, held to that file's bounds: >= 90% of frames tracked, a loop
closed and a GBA run with tracking still OK, loop edges on >= 2 alive
keyframes, ``check_structure`` clean, keyframe ATE < 0.35 m after the GBA
(and < 0.25 m, the file's drift bound).  The JAX system is not re-run here;
its own test drives it."""

import os

import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import CameraConfig as JCameraConfig
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.config import CameraConfig
from ccm_slam_tpu_torch.io.trajectory import ate_rmse, camera_centers
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.runtime.standalone import StandaloneSystem
from ccm_slam_tpu_torch.runtime.tracker import OK
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_standalone_loop import (_loop_cfg, circuit_trajectory, make_circuit_world,
                                        render_circuit_frame)


@pytest.fixture(scope="module")
def circuit():
    # The suite's longest module: beside the workers' even shares of the cores
    # (conftest.py) it also takes the cores that are left over.
    found = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(found + max(0, len(os.sched_getaffinity(0)) - found * workers))
    try:
        return run_circuit()
    finally:
        torch.set_num_threads(found)


def run_circuit():
    cfg = convert.system_config_from(_loop_cfg(4))
    jcam = JCamera.from_config(JCameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))
    cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
    poses, centers = circuit_trajectory()
    world = make_circuit_world(centers, seed=5)
    rng = np.random.RandomState(17)
    sys_ = StandaloneSystem(cfg=cfg, cam=cam, n_words=512, device="cpu")
    tracked = 0
    for i, T in enumerate(poses):
        fields = convert.frame_fields(render_circuit_frame(world, T, jcam, rng, multioctave=True))
        fields["timestamp"] = np.float32(i * 0.05)
        tracked += sys_.process_frame(convert.frame_from_numpy(fields, "cpu")) is not None
    gt = {round(i * 0.05, 3): -np.asarray(T.R).T @ np.asarray(T.t) for i, T in enumerate(poses)}
    return sys_, tracked, len(poses), gt


def test_tracks_the_whole_circuit(circuit):
    sys_, tracked, n, _ = circuit
    assert tracked >= 0.9 * n, (tracked, n)


def test_loop_closed_and_gba_ran(circuit):
    sys_, *_ = circuit
    assert sys_.stats["loops_closed"] >= 1
    assert sys_.stats["gba_runs"] >= 1
    assert sys_.tracker.state == OK
    assert int(torch.sum(sys_.finder.db.valid)) >= 10


def test_loop_edge_on_both_endpoints(circuit):
    m = circuit[0].tracker.map
    alive = (m.kfs.valid & ~m.kfs.bad).numpy()
    assert (alive & (m.kfs.loop_edges.numpy() >= 0).any(1)).sum() >= 2


def test_map_structure(circuit):
    errs = ms.check_structure(circuit[0].tracker.map)
    assert errs == [], errs[:10]


def test_keyframe_ate_after_gba(circuit):
    sys_, _, _, gt = circuit
    ts, R, t = sys_.keyframe_trajectory()
    est = camera_centers(torch.as_tensor(R), torch.as_tensor(t)).numpy()
    rmse, _ = ate_rmse(est, np.stack([gt[round(float(x), 3)] for x in ts]))
    assert rmse < 0.25, rmse  # the file's drift bound; its post-GBA bound is 0.35
