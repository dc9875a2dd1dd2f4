"""The port's server GBA scheduler (tests/test_server_gba.py's cases): the
interruptible chunked schedule (``idle_step``, chunks of 4 iterations
carrying the LM state, the cost left on the device) lands on the monolithic
12-iteration solve (poses 1e-6, positions 1e-5, cost 1e-6 relative); the
landmark-sharded GBA of ``Server(mesh=...)`` at world size 1 lands where the
unsharded one does (the same bounds); ``save_map`` then ``load_map`` restores
the slot; ``kf_idx_after_compact`` agrees with JAX's.
"""

import jax.numpy as jnp
import numpy as np
import torch

from ccm_slam_tpu.config import CameraConfig as JCameraConfig
from ccm_slam_tpu.runtime import map_matching as jmm
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert
from ccm_slam_tpu_torch.io import checkpoint
from ccm_slam_tpu_torch.config import CameraConfig
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.parallel import dist_ba
from ccm_slam_tpu_torch.runtime import map_matching
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_server_gba import build_map, small_cfg


def port_cam():
    return Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")


def jax_cam():
    return JCamera.from_config(JCameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))


def gba_servers():
    """tests/test_server_gba.py's server: one agent's perturbed 6-keyframe
    map (built by JAX, converted), chunks of 4 iterations, 12 in all;
    ``port_server(mesh)`` takes an optional ``dist_ba`` mesh."""
    jm = build_map(jax_cam())
    vocab = bow.Vocabulary(words=torch.zeros(16, 32, dtype=torch.uint8), idf=torch.ones(16))

    def port_server(mesh=None):
        srv = Server(cfg=convert.system_config_from(small_cfg()), cam=port_cam(), vocab=vocab,
                     n_agents=1, device="cpu", mesh=mesh)
        srv.maps[0] = convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")
        srv.agents[0].last_data_step = 0
        srv.gba_dirty[0] = True
        srv.gba_chunk_iters = 4
        srv.gba_total_iters = 12
        return srv

    return jm, port_server


def test_chunked_gba_equals_monolithic_and_reads_nothing_on_the_host():
    jm, port_server = gba_servers()
    chunked = port_server()
    chunked.idle_step()
    # a chunk leaves its cost on the device and carries the LM state
    assert 0 in chunked.gba_state and torch.is_tensor(chunked.gba_last_cost[0])
    for _ in range(2):
        chunked.idle_step()
    assert not chunked.gba_dirty[0] and 0 in chunked.gba_state
    mono = port_server()
    mono._run_gba(0, iters=12)
    assert 0 not in mono.gba_state
    np.testing.assert_allclose(chunked.maps[0].kfs.t_cw.numpy()[:6],
                               mono.maps[0].kfs.t_cw.numpy()[:6], atol=1e-6)
    np.testing.assert_allclose(chunked.maps[0].mps.pos.numpy()[:120],
                               mono.maps[0].mps.pos.numpy()[:120], atol=1e-5)
    assert abs(chunked.gba_cost(0) - mono.gba_cost(0)) <= 1e-6 * abs(mono.gba_cost(0)) + 1e-6
    assert [g[0] for g in chunked.stats["gba"]] == [4, 4, 4]
    # the chunks leave the two gauge anchors where they were
    np.testing.assert_array_equal(chunked.maps[0].kfs.t_cw.numpy()[:2],
                                  np.asarray(jm.kfs.t_cw)[:2])


def test_kf_idx_after_compact_matches_jax():
    jm = build_map(jax_cam())
    alive = np.random.RandomState(0).rand(16) < 0.6
    jm = jm.replace(kfs=jm.kfs.replace(bad=jnp.asarray(~alive)))
    m = convert.map_state_from_numpy(convert.map_state_fields(jm), "cpu")
    for k in range(6):
        assert map_matching.kf_idx_after_compact(m, k) == jmm.kf_idx_after_compact(jm, k)


def test_mesh_gba_lands_where_the_unsharded_gba_does():
    """Server(mesh=...) at world size 1 (gloo, in-process): the same
    12-iteration GBA through ``dist_ba_solve``."""
    _, port_server = gba_servers()
    sharded = port_server(dist_ba.make_mesh("cpu"))
    plain = port_server()
    cost_s, cost_p = sharded._run_gba(0, iters=12), plain._run_gba(0, iters=12)
    np.testing.assert_allclose(sharded.maps[0].kfs.t_cw.numpy()[:6],
                               plain.maps[0].kfs.t_cw.numpy()[:6], atol=1e-6)
    np.testing.assert_allclose(sharded.maps[0].mps.pos.numpy()[:120],
                               plain.maps[0].mps.pos.numpy()[:120], atol=1e-5)
    assert abs(cost_s - cost_p) <= 1e-6 * abs(cost_p) + 1e-6
    assert sharded.stats["gba"] == [(12, 16, False)] and plain.stats["gba"] == [(12, 16, True)]


def test_save_map_then_load_map_restores_the_slot(tmp_path):
    """save_map writes the slot's map; load_map into a fresh server gives it
    back remapped to client 0, with agent 0's tables and the banks filled."""
    _, port_server = gba_servers()
    src = port_server()
    src._run_gba(0, iters=4)
    path = str(tmp_path / "map.npz")
    src.save_map(0, path)
    dst = port_server()
    m = dst.load_map(0, path)
    want = convert.map_state_to_numpy(checkpoint.remap_to_client(src.maps[0]))
    got = convert.map_state_to_numpy(m)
    for sec in ("kfs", "mps"):
        for name, x in want[sec].items():
            np.testing.assert_array_equal(got[sec][name], x, err_msg=f"{sec}/{name}")
    ag = dst.agents[0]
    assert ag.kf_table == {k: k for k in range(6)} and len(ag.mp_table) == 120
    assert int(dst.finders[0].db.valid.sum()) == 6 and int(dst.matcher.db.valid.sum()) == 6
