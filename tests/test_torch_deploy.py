"""The port's multi-process deployment (``python -m ccm_slam_tpu_torch.deploy``)
on the CPU: a server and two synthetic clients as separate processes over
the native TCP channel, held to the gates of
``tests/test_multiprocess.py::test_two_agent_deployment``; the port's
modules import no JAX; the entry points raise without a card unless asked
for the CPU.

Tolerances: event counts and keyframe counts exact; co-located keyframes of
the two agents within 0.2 of a corridor step in the merged map, as the
reference's test.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccm_slam_tpu_torch import deploy, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 150


def port_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (REPO, env.get("PYTHONPATH")) if p)
    return env


def events(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            pass
    return [e for e in out if isinstance(e, dict)]


def test_two_agent_deployment(tmp_path):
    out = str(tmp_path / "mp")
    # one thread per process: three processes of small maps, which threads
    # only slow down where other tests share the cores
    env = {**port_env(), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "ccm_slam_tpu_torch.deploy", "launch", "--agents", "2",
         "--out", out, "--cpu", "--timeout", str(LAUNCH_TIMEOUT_S - 30)],
        capture_output=True, text=True, timeout=LAUNCH_TIMEOUT_S, env=env, cwd=tmp_path,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    ev = events(proc.stdout)
    kinds = [e.get("event") for e in ev]
    assert kinds.count("server_listening") == 1
    assert kinds.count("agent_connected") == 2 and kinds.count("agent_finished") == 2
    assert "server_timeout" not in kinds
    summary = [e for e in ev if e.get("event") == "run_summary"]
    assert summary, proc.stdout
    s = summary[0]
    assert s["merges"] >= 1 and kinds.count("map_merge") == s["merges"]
    assert s["agents_share_map"] is True
    done = [e for e in ev if e.get("event") == "client_done"]
    assert len(done) == 2
    assert all(d["kfs_acked"] == 4 for d in done)
    # every process reports its kernel launches (none on the CPU, where each
    # wrapper runs its plain version) and the server the work they follow from
    for e in [s, *done]:
        assert sorted(e["launches"]) == sorted(deploy._launches())
        assert set(e["launches"].values()) == {0}
    assert s["work"]["gba"] and s["work"]["bow_batches"] >= 4
    assert s["work"]["bow_transforms"] + s["work"]["sim3_attempts"] > 0
    for a in range(2):
        path = os.path.join(out, f"KF_GBA_{a}.csv")
        assert os.path.exists(path)
        rows = np.loadtxt(path)
        assert rows.shape == (4, 8)  # TUM: ts x y z qx qy qz qw
        assert s["trajectories"][str(a)] == {"path": path, "n_kfs": 4}
    # the merged gauge holds across processes: agent 0's corridor is x = 0,
    # 1, 2, 3 in keyframe order, agent 1's runs backwards x = 4, 3, 2, 1, so
    # rows (2, 2) and (3, 1) are co-located
    t0 = np.loadtxt(os.path.join(out, "KF_GBA_0.csv"))[:, 1:4]
    t1 = np.loadtxt(os.path.join(out, "KF_GBA_1.csv"))[:, 1:4]
    step = np.linalg.norm(t0[1] - t0[0])  # one corridor unit in the map gauge
    assert np.linalg.norm(t0[2] - t1[2]) < 0.2 * step, (t0, t1)
    assert np.linalg.norm(t0[3] - t1[1]) < 0.2 * step, (t0, t1)


def test_port_modules_import_no_jax():
    """Every module of the port, and the two entry points, in a fresh
    interpreter: neither jax nor the JAX package gets imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ccm_slam_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
        "'ccm_slam_tpu'))\n"
        "assert 'ccm_slam_tpu_torch.deploy' in names and 'ccm_slam_tpu_torch.run' in names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env=port_env(), cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("[]")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: nothing raises")
@pytest.mark.parametrize("argv", [
    ["server", "--port", "1", "--agents", "1"],
    ["client", "--agent", "0", "--connect", "127.0.0.1:1"],
])
def test_deploy_raises_without_a_card_unless_asked_for_the_cpu(argv):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        deploy.main(argv)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: nothing raises")
def test_run_raises_without_a_card_unless_asked_for_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--dataset", "rendered", "--seq", "corridor:0:4", "--out", str(tmp_path)])
