"""The port's landmark-sharded GBA across processes, and ``Server(mesh=...)``.

Two ranks of ``python -m ccm_slam_tpu_torch.parallel.dist_worker`` join one
gloo group through a ``FileStore`` under ``tmp_path`` and run every task of
one list (one launch for the whole file; the workers import no JAX):

* dense and PCG solves (``problems.arc_problem_arrays``; C=8, P=256 dense;
  C=12, P=1024 with ``CCM_PCG_MIN_C=4``, a shape no other test traces on a
  2-device mesh; tests/test_torch_dist_ba.py says why this size),
  monolithic (10 iterations) and in 2 chunks carrying the state, held
  against JAX's ``dist_ba_solve`` on a 2-device mesh (the first two of
  conftest's 8 CPU devices), so both sums carry 2 * 1e-8 on U's diagonal:
  t atol 1e-3, cost rtol 1e-2 (tests/test_dist_ba.py:28-29); chunked
  against monolithic: cost rtol 1e-5, t atol 1e-6;
* the mesh case of tests/test_server_gba.py:160 on the port's server: the
  map JAX's ``build_map`` makes, written by JAX's ``io.checkpoint.save_map``
  and read by the port's ``load_map``; 3 ``idle_step`` chunks of 4
  iterations against one 12-iteration GBA (poses 1e-6, positions 1e-5,
  cost 1e-6 relative, as tests/test_torch_server_gba.py holds the unsharded
  schedule), at world size 2 and in-process at world size 1.

Both ranks must report bit-identical costs, poses and (server) positions.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import CameraConfig as JCameraConfig
from ccm_slam_tpu.io import checkpoint as jckpt
from ccm_slam_tpu.parallel import dist_ba as jdist
from ccm_slam_tpu.solvers import ba as jba
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.config import CameraConfig
from ccm_slam_tpu_torch.io import checkpoint
from ccm_slam_tpu_torch.ops import bow
from ccm_slam_tpu_torch.parallel import dist_ba, dist_worker
from ccm_slam_tpu_torch.runtime.server import Server
from ccm_slam_tpu_torch.utils.camera import Camera
from tests.test_server_gba import C_KF, N_PTS, build_map, small_cfg

REPO = Path(__file__).resolve().parents[1]
SHAPES = {"dense": dict(C=8, P=256, K=4), "pcg": dict(C=12, P=1024, K=4)}
PCG_MIN_C = 4
ITERS = 10


def jax_problem(arr):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in arr.items()})


def task_list(tmp, map_path):
    tasks = []
    for branch, shape in SHAPES.items():
        path = tmp / f"{branch}.npz"
        np.savez(path, **problems.arc_problem_arrays(**shape))
        pcg = PCG_MIN_C if branch == "pcg" else None
        for chunks in (1, 2):
            tasks.append(dict(name=f"{branch}_{chunks}", kind="solve", problem=str(path),
                              iters=ITERS, chunks=chunks, pcg_min_c=pcg))
    for schedule in ("chunked", "monolithic"):
        tasks.append(dict(name=f"server_{schedule}", kind="server", map=str(map_path),
                          schedule=schedule))
    return tasks


@pytest.fixture(scope="module")
def map_path(tmp_path_factory):
    """tests/test_server_gba.py's map (``build_map``, jitted: eager, its
    ops compile one by one), written by JAX's save_map."""
    path = tmp_path_factory.mktemp("dist_map") / "map.npz"
    cam = JCamera.from_config(JCameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))
    jckpt.save_map(str(path), jax.jit(build_map)(cam))
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory, map_path):
    """Both ranks' results per task, {task: [rank 0, rank 1]} of (event,
    arrays), and JAX's 2-device solves {branch: (t, cost)}.  JAX runs while
    the workers do."""
    tmp = tmp_path_factory.mktemp("dist_mesh")
    (tmp / "tasks.json").write_text(json.dumps(task_list(tmp, map_path)))
    env = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ccm_slam_tpu_torch.parallel.dist_worker",
         "--store", str(tmp / "store"), "--world-size", "2", "--rank", str(r),
         "--tasks", str(tmp / "tasks.json"), "--out-dir", str(tmp / "out"), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    try:
        jm = jdist.make_mesh(jax.devices()[:2])
        ref = {}
        with pytest.MonkeyPatch.context() as mp:
            for branch, shape in SHAPES.items():
                if branch == "pcg":
                    mp.setenv("CCM_PCG_MIN_C", str(PCG_MIN_C))
                probs = jdist.shard_problem(jax_problem(problems.arc_problem_arrays(**shape)),
                                            jm)
                _, t, _, cost = jdist.dist_ba_solve(probs, jm, iters=ITERS)
                ref[branch] = (np.asarray(t), float(cost))
        outs = [p.communicate(timeout=dist_worker.TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    done = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("{"):
                e = json.loads(line)
                arrays = dict(np.load(tmp / "out" / f"{e['task']}.rank{e['rank']}.npz"))
                done.setdefault(e["task"], {})[e["rank"]] = (e, arrays)
    return {k: [v[0], v[1]] for k, v in done.items()}, ref


def test_two_ranks_agree_bit_for_bit(runs):
    done, _ = runs
    assert len(done) == 6
    for task, ((e0, a0), (e1, a1)) in done.items():
        assert (e0["world_size"], e0["backend"], e1["rank"]) == (2, "gloo", 1)
        assert e0["cost"] == e1["cost"] and e0["branch"] == e1["branch"], task
        for name in a0:
            if name != "X":  # a solve's X is each rank's own rows
                np.testing.assert_array_equal(a0[name], a1[name], err_msg=f"{task} {name}")


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_matches_jax_on_a_two_device_mesh(runs, branch):
    done, ref = runs
    (e, a), _ = done[f"{branch}_1"]
    t_ref, cost_ref = ref[branch]
    assert e["branch"] == branch
    np.testing.assert_allclose(a["t"], t_ref, atol=1e-3)
    np.testing.assert_allclose(e["cost"], cost_ref, rtol=1e-2)


@pytest.mark.parametrize("branch", ["dense", "pcg"])
def test_chunked_equals_monolithic_across_ranks(runs, branch):
    done, _ = runs
    (e1, a1), _ = done[f"{branch}_1"]
    (e2, a2), _ = done[f"{branch}_2"]
    np.testing.assert_allclose(e2["cost"], e1["cost"], rtol=1e-5)
    np.testing.assert_allclose(a2["t"], a1["t"], atol=1e-6)


def assert_chunked_equals_monolithic(chunked, mono):
    """(cost, R_cw, t_cw, pos) of two schedules: tests/test_torch_server_gba.py's bounds."""
    np.testing.assert_allclose(chunked[2][:C_KF], mono[2][:C_KF], atol=1e-6)
    np.testing.assert_allclose(chunked[3][:N_PTS], mono[3][:N_PTS], atol=1e-5)
    assert abs(chunked[0] - mono[0]) <= 1e-6 * abs(mono[0]) + 1e-6


def test_server_mesh_chunked_equals_monolithic_two_ranks(runs):
    done, _ = runs

    def result(schedule):
        e, a = done[f"server_{schedule}"][0]
        return e["cost"], a["R_cw"], a["t_cw"], a["pos"]

    assert_chunked_equals_monolithic(result("chunked"), result("monolithic"))


def test_server_mesh_chunked_equals_monolithic_in_process(map_path):
    """World size 1: the port's Server(mesh=make_mesh("cpu")) on the map
    JAX wrote, read with the port's load_map."""
    mesh = dist_ba.make_mesh("cpu")
    cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
    vocab = bow.Vocabulary(words=torch.zeros(16, 32, dtype=torch.uint8), idf=torch.ones(16))

    def server():
        srv = Server(cfg=convert.system_config_from(small_cfg()), cam=cam, vocab=vocab,
                     n_agents=1, device="cpu", mesh=mesh)
        srv.maps[0] = checkpoint.load_map(str(map_path), "cpu")
        srv.agents[0].last_data_step = 0
        srv.gba_dirty[0] = True
        srv.gba_chunk_iters, srv.gba_total_iters = 4, 12
        return srv

    def result(srv):
        m = srv.maps[0]
        return srv.gba_cost(0), m.kfs.R_cw.numpy(), m.kfs.t_cw.numpy(), m.mps.pos.numpy()

    chunked = server()
    for _ in range(3):
        chunked.idle_step()
    assert not chunked.gba_dirty[0] and 0 in chunked.gba_state
    mono = server()
    mono._run_gba(0, iters=12)
    assert_chunked_equals_monolithic(result(chunked), result(mono))
    # the mesh path computes no inlier statistics
    assert chunked.stats["gba"] == [(4, 16, False)] * 3 and mono.stats["gba"] == [(12, 16, False)]
