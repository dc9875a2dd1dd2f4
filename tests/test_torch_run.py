"""The port's runner (``python -m ccm_slam_tpu_torch.run``, ``run.main``) on
the CPU: a short rendered corridor at ``--factor 0.4`` (its outputs, and
KF_GBA_0.csv equal to the tracker's keyframes as ``write_tum`` writes them),
then an EuRoC-layout directory written from those frames (read through
``EurocSequence``, run with the default configuration).

Tolerances: written files equal as text; map checkpoints clean
(``check_structure``); counts exact.
"""

import contextlib
import io
import json

import numpy as np
import pytest
from PIL import Image

from ccm_slam_tpu_torch import run
from ccm_slam_tpu_torch.io import checkpoint, euroc
from ccm_slam_tpu_torch.io.trajectory import write_tum
from ccm_slam_tpu_torch.models import map_store as ms

SPEC = "corridor:0:20:0-0.05"  # 20 frames over the first 5% of the corridor


def main(argv, state=None):
    """run.main with its printed lines captured."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run.main(argv, state) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    """One agent over 6 rendered frames at 752x480 x 0.4, no server."""
    root = tmp_path_factory.mktemp("run")
    out, state = root / "rendered", {}
    printed = main(["--cpu", "--dataset", "rendered", "--seq", SPEC, "--factor", "0.4",
                    "--limit", "6", "--progress", "3", "--out", str(out)], state)
    return root, out, state, printed


def test_rendered_run_writes_its_products(rendered):
    _, out, state, printed = rendered
    tr = state["trackers"][0]
    assert state["server"] is None and tr.map is not None
    n_kf = int((tr.map.kfs.valid & ~tr.map.kfs.bad).sum())
    assert n_kf >= 3
    lines = printed.splitlines()
    assert f"agent 0: {n_kf} keyframes -> {out / 'KF_GBA_0.csv'}" in lines
    assert any(line.startswith("agent 0: ATE RMSE (Sim3) = ") for line in lines)
    assert sum(line.startswith("[agent 0] frame ") for line in lines) >= 2
    assert len(state["frame_walls"]) == 6 and min(state["frame_walls"]) > 0
    assert np.loadtxt(out / "KF_GBA_0.csv").shape == (n_kf, 8)
    m = checkpoint.load_map(str(out / "map_0.npz"), "cpu")
    assert ms.check_structure(m) == []
    n_mp = int((m.mps.valid & ~m.mps.bad).sum())
    assert f"element vertex {n_mp}" in (out / "map_0.ply").read_text()
    scene = json.loads((out / "scene_0.json").read_text())
    assert scene["n_keyframes"] == n_kf and scene["n_landmarks"] == n_mp


def tracker_keyframes_tum(m, path, t_sc):
    """The map's alive keyframes by keyframe id, written by ``write_tum``."""
    alive = (m.kfs.valid & ~m.kfs.bad).numpy()
    idx = np.where(alive)[0]
    idx = idx[np.argsort(m.kfs.kf_id.numpy()[idx])]
    write_tum(str(path), m.kfs.timestamp.numpy()[idx], m.kfs.R_cw.numpy()[idx],
              m.kfs.t_cw.numpy()[idx], t_sc=np.asarray(t_sc))
    return path.read_text()


def test_rendered_trajectory_is_the_trackers_keyframes(rendered):
    root, out, state, _ = rendered
    want = tracker_keyframes_tum(state["trackers"][0].map, root / "want.csv",
                                 state["cfg"].camera.t_sc)
    assert (out / "KF_GBA_0.csv").read_text() == want


def write_euroc(root, seq, n):
    """The first n frames of ``seq`` as an EuRoC-layout directory (PNGs,
    data.csv, ground truth at every frame)."""
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    rows, gt_rows = ["#timestamp [ns],filename"], ["#ts,px,py,pz,qw,qx,qy,qz"]
    gt_ts, gt_pos, gt_q = seq.ground_truth()
    for i, fr in enumerate(seq.frames(limit=n)):
        ts = int(round(fr.timestamp * 1e9))
        img = np.asarray(fr.image)
        assert (img == np.round(img)).all()  # 8-bit frames: the PNG holds them exactly
        Image.fromarray(img.astype(np.uint8)).save(cam / "data" / f"{ts}.png")
        rows.append(f"{ts},{ts}.png")
        gt_rows.append(f"{ts}," + ",".join(f"{x:.9f}" for x in (*gt_pos[i], *gt_q[i])))
    (cam / "data.csv").write_text("\n".join(rows) + "\n")
    (gt / "data.csv").write_text("\n".join(gt_rows) + "\n")
    return str(root)


def test_euroc_directory_run(rendered):
    root, _, state, _ = rendered
    euroc_root = write_euroc(root / "euroc", state["seqs"][0], 6)
    for a, b in zip(euroc.EurocSequence(euroc_root).frames(), state["seqs"][0].frames(limit=6)):
        assert abs(a.timestamp - b.timestamp) < 1e-9
        np.testing.assert_array_equal(a.image, np.asarray(b.image))
    out, st = root / "euroc_run", {}
    printed = main(["--cpu", "--seq", euroc_root, "--limit", "3", "--progress", "1",
                    "--traj-format", "tum", "--out", str(out)], st)
    tr = st["trackers"][0]
    assert st["server"] is None and tr.map is not None
    lines = printed.splitlines()
    assert [line.split(" state=")[0] for line in lines if line.startswith("[agent 0]")] == [
        f"[agent 0] frame {i}" for i in (1, 2, 3)]
    n_kf = int((tr.map.kfs.valid & ~tr.map.kfs.bad).sum())
    assert n_kf >= 2 and f"agent 0: {n_kf} keyframes -> {out / 'KF_GBA_0.csv'}" in lines
    want = tracker_keyframes_tum(tr.map, root / "want_euroc.csv", st["cfg"].camera.t_sc)
    assert (out / "KF_GBA_0.csv").read_text() == want
    m = checkpoint.load_map(str(out / "map_0.npz"), "cpu")
    assert ms.check_structure(m) == [] and int(m.next_kf) == int(tr.map.next_kf)
    assert (out / "map_0.ply").read_text().startswith("ply\n")
    assert json.loads((out / "scene_0.json").read_text())["n_keyframes"] == n_kf
