"""The port's IO tails against the JAX package: telemetry
(``runtime/telemetry.py``), ``config.show_params`` and ``KITTI_CAMERA``, the
EuRoC and KITTI readers (``io/euroc.py``, ``io/kitti.py``, on directories
the tests write) and the synthetic worlds (``io/synthetic.py``).

Inputs are numpy from a seed.  Tolerances: parameter text, readers' indices,
frames, calibration, ground truth and ``associate_gt`` exact;
``build_agent_map``'s landmark positions and keyframe poses within 1e-5,
every other field exact.
"""

import time

import jax
import numpy as np
import pytest
from PIL import Image

from ccm_slam_tpu import config as jconfig
from ccm_slam_tpu.io import euroc as jeuroc
from ccm_slam_tpu.io import kitti as jkitti
from ccm_slam_tpu.io import synthetic as jsyn
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu_torch import config, convert
from ccm_slam_tpu_torch.io import euroc, kitti, synthetic
from ccm_slam_tpu_torch.runtime.telemetry import Counters, StageTimer, Watchdog

T0_NS = 1403636579763555584


def test_stage_timer_counters_and_watchdog():
    t = StageTimer()
    with t.stage("tracking"):
        time.sleep(0.01)
    with t.stage("tracking"):
        time.sleep(0.01)
    with t.stage("gba"):
        pass
    s = t.summary()
    assert list(s) == ["gba", "tracking"]
    assert s["tracking"]["count"] == 2
    assert s["tracking"]["total_s"] >= 0.02
    assert s["tracking"]["total_s"] == round(t.totals["tracking"], 4)
    assert s["tracking"]["mean_ms"] == round(1000 * t.totals["tracking"] / 2, 3)
    assert t.sync is False

    c = Counters()
    c.bump("kf_created")
    c.bump("kf_created", 2)
    c.bump("bow_batches")
    assert c.get("kf_created") == 3
    assert list(c.summary().items()) == [("bow_batches", 1), ("kf_created", 3)]

    w = Watchdog(threshold_s=0.005)
    w.beat("mapping")
    time.sleep(0.02)
    w2 = Watchdog(threshold_s=30.0)
    w2.beat("mapping")
    stalled = w.stalled()
    assert stalled and stalled[0][0] == "mapping" and stalled[0][1] >= 0.0
    assert w2.stalled() == []


@pytest.mark.parametrize("which", ["default", "rendered_0.4", "rendered_1.0", "kitti"])
def test_show_params_matches_jax(which):
    jcfg = {"default": jconfig.DEFAULT_CONFIG,
            "rendered_0.4": jconfig.rendered_ci_config(0.4),
            "rendered_1.0": jconfig.rendered_ci_config(1.0),
            "kitti": jconfig.DEFAULT_CONFIG.replace(camera=jconfig.KITTI_CAMERA)}[which]
    ours = config.show_params(convert.system_config_from(jcfg))
    ref = jconfig.show_params(jcfg)
    assert ours.splitlines()[0] == "ccm_slam_tpu_torch parameters"
    assert ours.splitlines()[1:] == ref.splitlines()[1:]
    assert "<4x4 matrix>" in ours


def test_show_params_prints_to_file(capsys):
    import sys

    out = config.show_params(file=sys.stdout)
    assert capsys.readouterr().out == out + "\n"
    assert out == config.show_params(config.DEFAULT_CONFIG)


def test_kitti_camera_matches_jax():
    import dataclasses

    for f in dataclasses.fields(config.CameraConfig):
        assert getattr(config.KITTI_CAMERA, f.name) == getattr(jconfig.KITTI_CAMERA, f.name), f.name


def write_euroc(root, n=7, gt_n=14, seed=0):
    """An EuRoC-layout directory: n random 48x64 PNGs (one RGB), data.csv
    rows out of time order, and a ground-truth CSV at twice the frame rate."""
    cam = root / "mav0" / "cam0"
    (cam / "data").mkdir(parents=True)
    rows = ["#timestamp [ns],filename"]
    rng = np.random.RandomState(seed)
    for i in rng.permutation(n):
        ts = T0_NS + int(i) * 50_000_000
        img = rng.randint(0, 255, (48, 64, 3) if i == 2 else (48, 64), dtype=np.uint8)
        Image.fromarray(img).save(str(cam / "data" / f"{ts}.png"))
        rows.append(f"{ts}, {ts}.png")
    (cam / "data.csv").write_text("\n".join(rows) + "\n\n")
    gt = root / "mav0" / "state_groundtruth_estimate0"
    gt.mkdir(parents=True)
    gt_rows = ["#ts,px,py,pz,qw,qx,qy,qz,..."]
    for i in range(gt_n):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        p = rng.randn(3)
        gt_rows.append(f"{T0_NS + i * 25_000_000}," + ",".join(f"{x:.9f}" for x in (*p, *q))
                       + ",0.1,0.2")
    (gt / "data.csv").write_text("\n".join(gt_rows) + "\n")
    return str(root)


def write_kitti(root, seq="07", n=6, seed=1):
    seq_dir = root / "sequences" / seq
    (seq_dir / "image_0").mkdir(parents=True)
    (root / "poses").mkdir()
    rng = np.random.RandomState(seed)
    for i in range(n):
        Image.fromarray(rng.randint(0, 255, (30, 100), dtype=np.uint8)).save(
            seq_dir / "image_0" / f"{i:06d}.png")
    (seq_dir / "times.txt").write_text("".join(f"{i * 0.1037:.6e}\n" for i in range(n)) + "\n")
    (seq_dir / "calib.txt").write_text(
        "P0: 7.188560000000e+02 0.0 6.071928000000e+02 0.0 0.0 718.856 185.2157 0.0 "
        "0.0 0.0 1.0 0.0\n"
        "P1: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    poses = [" ".join(f"{x:.9e}" for x in rng.randn(12)) for _ in range(n + 2)]
    (root / "poses" / f"{seq}.txt").write_text("\n".join(poses) + "\n")
    return str(root)


def assert_frames_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert a.timestamp == b.timestamp
        assert a.image.dtype == b.image.dtype == np.float32
        np.testing.assert_array_equal(a.image, b.image)


def test_euroc_sequence_matches_jax(tmp_path):
    root = write_euroc(tmp_path)
    ours, ref = euroc.EurocSequence(root=root), jeuroc.EurocSequence(root=root)
    assert ours.frame_index() == ref.frame_index()
    assert [t for t, _ in ours.frame_index()] == sorted(t for t, _ in ours.frame_index())
    for start, limit in ((0.0, None), (0.1, 2), (0.12, None), (0.0, 1), (1.0, None)):
        assert_frames_equal(list(ours.frames(start=start, limit=limit)),
                            list(ref.frames(start=start, limit=limit)))
    assert len(list(ours.frames(start=0.1, limit=2))) == 2
    for a, b in zip(ours.ground_truth(), ref.ground_truth()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_associate_gt_matches_jax(tmp_path):
    root = write_euroc(tmp_path)
    gt_ts, gt_pos, _ = euroc.EurocSequence(root=root).ground_truth()
    rng = np.random.RandomState(3)
    # inside, between, at the ends and beyond the ground truth's span
    est_ts = np.concatenate([gt_ts[[0, 4, 13]] + 0.001, gt_ts[:3] + 0.0125,
                             gt_ts[0] + rng.uniform(-0.1, 0.45, 20), [gt_ts[-1] + 0.05]])
    for max_dt in (0.02, 0.005):
        m1, p1 = euroc.associate_gt(est_ts, gt_ts, gt_pos, max_dt=max_dt)
        m2, p2 = jeuroc.associate_gt(est_ts, gt_ts, gt_pos, max_dt=max_dt)
        np.testing.assert_array_equal(m1, m2)
        np.testing.assert_array_equal(p1, p2)
        assert 0 < m1.sum() < len(est_ts)


def test_kitti_sequence_matches_jax(tmp_path):
    root = write_kitti(tmp_path)
    ours, ref = kitti.KittiSequence(root=root, seq="07"), jkitti.KittiSequence(root=root, seq="07")
    assert ours.calibration() == ref.calibration()
    assert ours.calibration() == (718.856, 718.856, 607.1928, 185.2157)
    assert ours.frame_index() == ref.frame_index()
    for start, limit in ((0.0, None), (0.15, None), (0.15, 2), (0.0, 1)):
        assert_frames_equal(list(ours.frames(start=start, limit=limit)),
                            list(ref.frames(start=start, limit=limit)))
    for a, b in zip(ours.ground_truth(), ref.ground_truth()):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert ours.ground_truth()[1].shape == (6, 3)


def test_kitti_calibration_without_p0_raises(tmp_path):
    root = write_kitti(tmp_path)
    (tmp_path / "sequences" / "07" / "calib.txt").write_text("P1: 1 0 0 0 0 1 0 0 0 0 1 0\n")
    with pytest.raises(ValueError, match="P0"):
        kitti.KittiSequence(root=root, seq="07").calibration()


@pytest.fixture(scope="module")
def jax_agent_maps():
    """JAX's build_agent_map for agents 0 and 1, with the map store's two
    entry points jitted while it runs (eager, each op compiles apart)."""
    world, wdesc = jsyn.make_world(np.random.RandomState(2), n=300)
    orig = jms.add_mappoints, jms.add_keyframe
    jms.add_mappoints, jms.add_keyframe = jax.jit(orig[0]), jax.jit(orig[1])
    try:
        maps = {a: convert.map_state_fields(jsyn.build_agent_map(
            world, wdesc, jsyn.agent_corridor(a), jsyn.agent_gauge(a), client_id=a))
            for a in (0, 1)}
    finally:
        jms.add_mappoints, jms.add_keyframe = orig
    return world, wdesc, maps


def test_make_world_and_corridors_match_jax(jax_agent_maps):
    world, wdesc, _ = jax_agent_maps
    ours = synthetic.make_world(np.random.RandomState(2), n=300)
    np.testing.assert_array_equal(ours[0], world)
    np.testing.assert_array_equal(ours[1], wdesc)
    for a in range(4):
        for n in (3, 4):
            assert synthetic.agent_corridor(a, n) == jsyn.agent_corridor(a, n)
        g, jg = synthetic.agent_gauge(a, "cpu"), jsyn.agent_gauge(a)
        np.testing.assert_allclose(float(g.s), float(jg.s), rtol=0, atol=0)
        np.testing.assert_allclose(g.R.numpy(), np.asarray(jg.R), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(g.t.numpy(), np.asarray(jg.t))


@pytest.mark.parametrize("agent", [0, 1])
def test_build_agent_map_matches_jax(jax_agent_maps, agent):
    world, wdesc, maps = jax_agent_maps
    m = synthetic.build_agent_map(world, wdesc, synthetic.agent_corridor(agent),
                                  synthetic.agent_gauge(agent, "cpu"), client_id=agent,
                                  device="cpu")
    ours, ref = convert.map_state_to_numpy(m), maps[agent]
    close = {("mps", "pos"), ("kfs", "R_cw"), ("kfs", "t_cw")}
    for sec in ("kfs", "mps"):
        for name, want in ref[sec].items():
            got, want = ours[sec][name], np.asarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape, (sec, name)
            if (sec, name) in close:
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f"{sec}/{name}")
    for name in ("next_kf", "next_mp", "insert_counter"):
        assert int(ours[name]) == int(ref[name])
    assert int(ours["next_kf"]) == 4 and int(ours["next_mp"]) > 0


def test_vocabulary_seeds_from_one_frame_order_like_jax():
    """One frame's descriptors: 900 valid of 1,024 slots, 1,024 words.  Both
    packages seed the words with every valid descriptor (each draws its own
    order) and then the invalid ones in index order; the runner's
    bootstrap draws from a torch.Generator seeded 0 where the reference
    uses PRNGKey(0), so only that order differs."""
    import jax.numpy as jnp
    import torch

    from ccm_slam_tpu_torch.ops import bow

    rng = np.random.RandomState(4)
    desc = rng.randint(0, 256, (1024, 32), dtype=np.uint8)
    valid = np.zeros(1024, bool)
    valid[rng.choice(1024, 900, replace=False)] = True
    ours = bow.train_vocabulary(torch.as_tensor(desc), torch.as_tensor(valid), n_words=1024,
                                iters=0, generator=torch.Generator().manual_seed(0))
    # the reference's seeds, drawn as its train_vocabulary draws them
    # (ccm_slam_tpu/ops/bow.py:63; its loop needs at least one iteration)
    p = jnp.asarray(valid, jnp.float32) / jnp.clip(jnp.sum(jnp.asarray(valid)), 1)
    perm = jax.random.choice(jax.random.PRNGKey(0), 1024, shape=(1024,), replace=False, p=p)
    words, jwords = ours.words.numpy(), desc[np.asarray(perm)]
    np.testing.assert_array_equal(words[900:], desc[~valid])
    np.testing.assert_array_equal(jwords[900:], desc[~valid])
    key = lambda w: sorted(map(bytes, w))  # noqa: E731
    assert key(words[:900]) == key(jwords[:900]) == key(desc[valid])
    assert not np.array_equal(words[:900], desc[valid])  # drawn, not in index order
