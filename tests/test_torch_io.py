"""The run's products in the port against the JAX package: trajectory
writers (``io/trajectory.py``), map checkpoints (``io/checkpoint.py``,
``Server.save_map`` / ``Server.load_map``) and scene export
(``io/export.py``).

Inputs are numpy from a seed: random poses, and ``problems.client_map_arrays``
with some keyframes and landmarks erased, a second client and loop edges.
Tolerances: written trajectories, parsed numbers within 1e-6; checkpoints,
tables and registrations equal (BoW vectors within 1e-6); PLY text equal;
scene JSON equal in structure and integers, coordinates within 1e-6;
annotated frames equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.io import checkpoint as jckpt
from ccm_slam_tpu.io import export as jexport
from ccm_slam_tpu.io import trajectory as jtraj
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.runtime.server import Server as JServer
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.config import CameraConfig
from ccm_slam_tpu_torch.io import checkpoint, export, trajectory
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_server_gba import small_cfg

# JAX's remap_to_client, jitted (eager, its compaction compiles op by op)
JAX_REMAP = jax.jit(jckpt.remap_to_client, static_argnames="client_id")


def jax_map(fields):
    return jms.MapState(
        kfs=jms.KeyFrameStore(**{k: jnp.asarray(v) for k, v in fields["kfs"].items()}),
        mps=jms.MapPointStore(**{k: jnp.asarray(v) for k, v in fields["mps"].items()}),
        next_kf=jnp.int32(fields["next_kf"]), next_mp=jnp.int32(fields["next_mp"]),
        insert_counter=jnp.int32(fields["insert_counter"]))


def map_fields():
    """A client map with two keyframes and 20 landmarks erased, keyframes 4
    and 5 and every third landmark owned by client 1, and loop edges 0-5 and
    1-4 (stored on both ends)."""
    fields, _, _ = problems.client_map_arrays(n_kf=8, max_obs=8, seed=4)
    kfs, mps = fields["kfs"], fields["mps"]
    kfs["bad"][[2, 6]] = True
    kfs["client_id"][[4, 5]] = 1
    for a, b in ((0, 5), (1, 4)):
        kfs["loop_edges"][a, 0], kfs["loop_edges"][b, 0] = b, a
    n = int(fields["next_mp"])
    mps["bad"][np.arange(0, n, n // 20)[:20]] = True
    mps["client_id"][:n][np.arange(n) % 3 == 0] = 1
    return fields


def assert_fields_equal(a, b, what):
    for sec in ("kfs", "mps"):
        for name, x in a[sec].items():
            y = np.asarray(b[sec][name])
            assert x.dtype == y.dtype, (what, sec, name, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f"{what}: {sec}/{name}")
    for name in ("next_kf", "next_mp", "insert_counter"):
        assert int(a[name]) == int(b[name]), (what, name)


def random_poses(n=7, seed=3):
    rs = np.random.RandomState(seed)
    q = rs.randn(n, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)
    t = rs.randn(n, 3).astype(np.float32)
    ts = 1403636579.763555 + 0.05 * np.arange(n)
    return ts, R, t


def parse(path, sep):
    return [np.array([float(v) for v in line.split(sep)]) for line in open(path)]


@pytest.mark.parametrize("body", [False, True], ids=["camera", "body"])
@pytest.mark.parametrize("fmt", ["tum", "euroc"])
def test_trajectory_writers_match_jax(tmp_path, fmt, body):
    ts, R, t = random_poses()
    t_sc = np.asarray(CameraConfig().t_sc, np.float64).reshape(4, 4) if body else None
    ours, ref = tmp_path / "ours.txt", tmp_path / "ref.txt"
    getattr(trajectory, f"write_{fmt}")(ours, ts, torch.as_tensor(R), torch.as_tensor(t), t_sc)
    getattr(jtraj, f"write_{fmt}")(ref, ts, R, t, t_sc)
    sep = " " if fmt == "tum" else ","
    a, b = parse(ours, sep), parse(ref, sep)
    assert len(a) == len(b) == len(ts)
    for x, y in zip(a, b):
        assert x.shape == y.shape == ((8,) if fmt == "tum" else (17,))
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-6)
    np.testing.assert_allclose(trajectory.rot_cw_to_quat_wc(torch.as_tensor(R)).numpy(),
                               np.asarray(jtraj.rot_cw_to_quat_wc(jnp.asarray(R))), atol=1e-6)


def test_each_package_reads_the_others_map(tmp_path):
    fields = map_fields()
    port_path, jax_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    checkpoint.save_map(port_path, convert.map_state_from_numpy(fields, "cpu"))
    jckpt.save_map(jax_path, jax_map(fields))
    a, b = np.load(port_path), np.load(jax_path)
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a.keys():
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert_fields_equal(convert.map_state_to_numpy(checkpoint.load_map(jax_path, "cpu")),
                        convert.map_state_fields(jckpt.load_map(port_path)), "cross")
    assert_fields_equal(convert.map_state_to_numpy(checkpoint.load_map(port_path, "cpu")),
                        fields, "round trip")
    # dtypes are cast on load, as JAX's load_map does
    wide = {k: (v.astype(np.int64) if v.dtype == np.int32 else
                v.astype(np.float64) if v.dtype == np.float32 else v) for k, v in b.items()}
    np.savez(tmp_path / "wide.npz", **wide)
    assert_fields_equal(convert.map_state_to_numpy(checkpoint.load_map(
        str(tmp_path / "wide.npz"), "cpu")), fields, "cast")


def test_save_pytree_matches_jax(tmp_path):
    """One map, a vocabulary and a tree of dicts and tuples: the same keys
    and arrays as the JAX package's ``save_pytree``."""
    fields = map_fields()
    rs = np.random.RandomState(6)
    words, idf = rs.randint(0, 256, (8, 32)).astype(np.uint8), rs.rand(8).astype(np.float32)
    a, b = rs.rand(3, 2).astype(np.float32), np.arange(5, dtype=np.int32)
    cases = [(convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)),
             (bow.Vocabulary(words=torch.as_tensor(words), idf=torch.as_tensor(idf)),
              jbow.Vocabulary(words=jnp.asarray(words), idf=jnp.asarray(idf))),
             ({"b": (torch.as_tensor(a), None, [torch.as_tensor(b)]), "a": torch.tensor(7, dtype=torch.int32)},
              {"b": (jnp.asarray(a), None, [jnp.asarray(b)]), "a": jnp.int32(7)})]
    for i, (ours, ref) in enumerate(cases):
        checkpoint.save_pytree(str(tmp_path / f"port{i}.npz"), ours)
        jckpt.save_pytree(str(tmp_path / f"jax{i}.npz"), ref)
        x, y = np.load(tmp_path / f"port{i}.npz"), np.load(tmp_path / f"jax{i}.npz")
        assert sorted(x.keys()) == sorted(y.keys()), i
        for k in y.keys():
            assert x[k].dtype == y[k].dtype and x[k].shape == y[k].shape, (i, k)
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    assert sorted(np.load(tmp_path / "jax2.npz").keys()) == ["['a']", "['b']/0", "['b']/2/0"]


def test_remap_to_client_matches_jax():
    fields = map_fields()
    ours = checkpoint.remap_to_client(convert.map_state_from_numpy(fields, "cpu"), client_id=3)
    ref = JAX_REMAP(jax_map(fields), client_id=3)
    assert_fields_equal(convert.map_state_to_numpy(ours), convert.map_state_fields(ref),
                        "remap")
    n_kf = int(ours.next_kf)
    assert n_kf == 6 and ours.kfs.kf_id[:n_kf].tolist() == list(range(n_kf))
    assert set(ours.kfs.client_id[:n_kf].tolist()) == {3}


def test_vocabulary_round_trips(tmp_path):
    rs = np.random.RandomState(5)
    words, idf = rs.randint(0, 256, (64, 32)).astype(np.uint8), rs.rand(64).astype(np.float32)
    checkpoint.save_vocabulary(str(tmp_path / "port.npz"), bow.Vocabulary(
        words=torch.as_tensor(words), idf=torch.as_tensor(idf)))
    jckpt.save_vocabulary(str(tmp_path / "jax.npz"), jbow.Vocabulary(
        words=jnp.asarray(words), idf=jnp.asarray(idf)))
    for path in ("port.npz", "jax.npz"):
        ours = checkpoint.load_vocabulary(str(tmp_path / path), "cpu")
        ref = jckpt.load_vocabulary(str(tmp_path / path))
        for v in (ours.words.numpy(), np.asarray(ref.words)):
            np.testing.assert_array_equal(v, words)
        for v in (ours.idf.numpy(), np.asarray(ref.idf)):
            np.testing.assert_array_equal(v, idf)


def test_server_save_and_load_map_match_jax(tmp_path, monkeypatch):
    """Server.save_map writes JAX's file; Server.load_map gives JAX's map,
    agent 0's id tables and the loop finder's and matcher's registrations
    (JAX's server remaps through the jitted remap_to_client)."""
    monkeypatch.setattr(jckpt, "remap_to_client", JAX_REMAP)
    fields = map_fields()
    rs = np.random.RandomState(6)
    words = rs.randint(0, 256, (16, 32)).astype(np.uint8)
    idf = (0.5 + rs.rand(16)).astype(np.float32)
    cfg = small_cfg()
    jcam = JCamera.from_config(cfg.camera)
    jsrv = JServer(cfg=cfg, cam=jcam, vocab=jbow.Vocabulary(words=jnp.asarray(words),
                                                            idf=jnp.asarray(idf)), n_agents=1)

    def port_server():
        return Server(cfg=convert.system_config_from(cfg),
                      cam=Camera.from_config(CameraConfig(), "cpu"),
                      vocab=bow.Vocabulary(words=torch.as_tensor(words),
                                           idf=torch.as_tensor(idf)),
                      n_agents=1, device="cpu")

    saver = port_server()
    saver.maps[0] = convert.map_state_from_numpy(fields, "cpu")
    ours_path, ref_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    saver.save_map(0, ours_path)
    jsrv.maps[0] = jax_map(fields)
    jsrv.save_map(0, ref_path)
    a, b = np.load(ours_path), np.load(ref_path)
    for k in b.keys():
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    srv = port_server()
    srv.gba_state[0] = "stale carry"
    m = srv.load_map(0, ours_path)
    jm = jsrv.load_map(0, ours_path)
    assert_fields_equal(convert.map_state_to_numpy(m), convert.map_state_fields(jm), "load")
    assert m is srv.maps[0] and 0 not in srv.gba_state
    ag, jag = srv.agents[0], jsrv.agents[0]
    assert ag.map_slot == jag.map_slot == 0
    assert ag.kf_table == jag.kf_table and len(ag.kf_table) == 6
    assert ag.mp_table == jag.mp_table and len(ag.mp_table) > 50
    assert ag.ing_tables is None
    for ours, ref in ((srv.finders[0].db, jsrv.finders[0].db), (srv.matcher.db, jsrv.matcher.db)):
        f = convert.keyframe_db_fields(ref)
        np.testing.assert_array_equal(ours.valid.numpy(), f["valid"])
        np.testing.assert_array_equal(ours.map_id.numpy(), f["map_id"])
        np.testing.assert_allclose(ours.vectors.numpy(), f["vectors"], atol=1e-6)
    assert int(srv.finders[0].db.valid.sum()) == 6


@pytest.mark.parametrize("covis_min_weight", [100, 20])
def test_ply_and_scene_json_match_jax(tmp_path, covis_min_weight):
    fields = map_fields()
    m, jm = convert.map_state_from_numpy(fields, "cpu"), jax_map(fields)
    n = export.export_pointcloud_ply(str(tmp_path / "ours.ply"), m)
    assert n == jexport.export_pointcloud_ply(str(tmp_path / "ref.ply"), jm) > 0
    assert (tmp_path / "ours.ply").read_text() == (tmp_path / "ref.ply").read_text()
    export.export_scene_json(str(tmp_path / "ours.json"), m, covis_min_weight)
    jexport.export_scene_json(str(tmp_path / "ref.json"), jm, covis_min_weight)
    ours = json.loads((tmp_path / "ours.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())

    def same(x, y, where):
        assert type(x) is type(y), where
        if isinstance(x, dict):
            assert x.keys() == y.keys(), where
            for k in x:
                same(x[k], y[k], f"{where}/{k}")
        elif isinstance(x, list):
            assert len(x) == len(y), where
            for i, (u, v) in enumerate(zip(x, y)):
                same(u, v, f"{where}[{i}]")
        elif isinstance(x, float):
            assert abs(x - y) <= 1e-6, (where, x, y)
        else:
            assert x == y, (where, x, y)

    same(ours, ref, "scene")
    assert ours["loop_edges"] == [[0, 5], [1, 4]]
    assert set(ours["trajectories"]) == {"0", "1"}
    assert (len(ours["covisibility_edges"]) > 0) == (covis_min_weight == 20)


def test_annotate_frame_matches_jax():
    rs = np.random.RandomState(7)
    h, w, n = 40, 60, 50
    img = rs.uniform(-20, 280, (h, w)).astype(np.float32)
    xy = np.stack([rs.uniform(-5, w + 5, n), rs.uniform(-5, h + 5, n)], 1).astype(np.float32)
    valid = rs.rand(n) < 0.8
    mp = np.where(rs.rand(n) < 0.5, rs.randint(0, 100, n), -1).astype(np.int32)

    class Frame:  # the fields annotate_frame reads
        def __init__(self, conv):
            self.xy, self.valid, self.mp = conv(xy), conv(valid), conv(mp)

    ours = export.annotate_frame(torch.as_tensor(img), Frame(torch.as_tensor), radius=3)
    ref = jexport.annotate_frame(img, Frame(np.asarray), radius=3)
    assert ours.dtype == np.uint8 and ours.shape == (h, w, 3)
    np.testing.assert_array_equal(ours, ref)
    assert (ours[..., 1] == 220).any() and (ours[..., 0] == 220).any()
