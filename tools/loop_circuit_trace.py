"""The loop circuit of ``tests/test_standalone_loop.py`` through either package, traced.

    python3 tools/loop_circuit_trace.py jax|torch [--seed 17] [--jax-culling] [--decisions N]

Drives ``StandaloneSystem.process_frame`` of the JAX package or of the port
(on the CPU) over the circuit that ``tests/test_standalone_loop.py`` and
``tests/test_torch_standalone.py`` run (``circuit_trajectory``,
``make_circuit_world(seed=5)``, ``render_circuit_frame`` with noise drawn
from ``RandomState(seed)``, ``_loop_cfg(4)``, 512 words).  Prints a line per
loop closure (frame, keyframe ids of the loop-edge endpoints), per culled
keyframe that held a loop edge, and at the end the frames tracked, the
system's stats, the loop-edge endpoints and how many are alive (the test's
gate wants >= 2), and the keyframe ATE.  ``--jax-culling`` runs the port
with the JAX package's culling rule: ``cull_redundant_keyframes`` with the
loop edges hidden from it.  ``--decisions N`` also prints, for each of the
first N frames, the tracker's keyframe and landmark counts: the first
frame where two runs differ is where they depart.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_default_matmul_precision", "highest")

import jax.numpy as jnp  # noqa: E402

from ccm_slam_tpu.config import CameraConfig as JCameraConfig  # noqa: E402
from ccm_slam_tpu.utils.camera import Camera as JCamera  # noqa: E402
from tests.test_standalone_loop import (_loop_cfg, circuit_trajectory,  # noqa: E402
                                        make_circuit_world, render_circuit_frame)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("package", choices=("jax", "torch"))
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--jax-culling", action="store_true")
    ap.add_argument("--decisions", type=int, default=0)
    a = ap.parse_args()

    jcam = JCamera.from_config(JCameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))
    if a.package == "jax":
        from ccm_slam_tpu.io.trajectory import ate_rmse
        from ccm_slam_tpu.runtime import mapping, standalone
        host = np.asarray
        system = standalone.StandaloneSystem(cfg=_loop_cfg(4), cam=jcam, n_words=512)

        def frame_of(f, ts):
            return f.replace(timestamp=jnp.float32(ts))
    else:
        import torch

        from ccm_slam_tpu_torch import convert
        from ccm_slam_tpu_torch.config import CameraConfig
        from ccm_slam_tpu_torch.io.trajectory import ate_rmse
        from ccm_slam_tpu_torch.runtime import mapping, standalone
        from ccm_slam_tpu_torch.utils.camera import Camera
        host = lambda x: x.cpu().numpy()  # noqa: E731
        if a.jax_culling:
            port_cull = mapping.cull_redundant_keyframes

            def jax_cull(m, cfg, *args, **kw):
                # the loop edges hidden from the culling, then put back
                edges = m.kfs.loop_edges
                hidden = m.kfs.replace(loop_edges=torch.full_like(edges, -1))
                m2, n = port_cull(m.replace(kfs=hidden), cfg, *args, **kw)
                return m2.replace(kfs=m2.kfs.replace(loop_edges=edges)), n

            mapping.cull_redundant_keyframes = jax_cull
        cam = Camera.from_config(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), "cpu")
        system = standalone.StandaloneSystem(cfg=convert.system_config_from(_loop_cfg(4)),
                                             cam=cam, n_words=512, device="cpu")

        def frame_of(f, ts):
            fields = convert.frame_fields(f)
            fields["timestamp"] = np.float32(ts)
            return convert.frame_from_numpy(fields, "cpu")

    frame_no = [0]
    cull = mapping.cull_redundant_keyframes

    def traced_cull(m, cfg, *args, **kw):
        before = host(m.kfs.valid & ~m.kfs.bad)
        looped = (host(m.kfs.loop_edges) >= 0).any(1)
        m2, n = cull(m, cfg, *args, **kw)
        gone = before & ~host(m2.kfs.valid & ~m2.kfs.bad) & looped
        if gone.any():
            print(f"frame {frame_no[0]}: culled loop-edge keyframes "
                  f"{host(m.kfs.kf_id)[gone].tolist()}", flush=True)
        return m2, n

    mapping.cull_redundant_keyframes = traced_cull

    poses, centers = circuit_trajectory()
    world = make_circuit_world(centers, seed=5)
    rng = np.random.RandomState(a.seed)
    tracked = 0
    for i, T in enumerate(poses):
        frame_no[0] = i
        closed = system.stats["loops_closed"]
        out = system.process_frame(frame_of(
            render_circuit_frame(world, T, jcam, rng, multioctave=True), i * 0.05))
        tracked += out is not None
        s = system.tracker.stats
        if i < a.decisions:
            print(f"frame {i}: tracked {out is not None} kf_created {s['kf_created']} "
                  f"mp_created {s['mp_created']}", flush=True)
        if system.stats["loops_closed"] > closed:
            m = system.tracker.map
            ends = (host(m.kfs.loop_edges) >= 0).any(1)
            print(f"frame {i}: loop closed; loop-edge endpoints (kf ids) "
                  f"{host(m.kfs.kf_id)[ends].tolist()}", flush=True)
    m = system.tracker.map
    alive = host(m.kfs.valid & ~m.kfs.bad)
    ends = (host(m.kfs.loop_edges) >= 0).any(1)
    ts, R, t = system.keyframe_trajectory()
    est = -np.einsum("nji,nj->ni", R, t)
    gt = {round(i * 0.05, 3): -np.asarray(T.R).T @ np.asarray(T.t) for i, T in enumerate(poses)}
    rmse, _ = ate_rmse(est, np.stack([gt[round(float(x), 3)] for x in ts]))
    print(f"end: tracked {tracked}/{len(poses)}, stats {system.stats}, loop-edge endpoints "
          f"(kf id, alive) {list(zip(host(m.kfs.kf_id)[ends].tolist(), alive[ends].tolist()))}, "
          f"alive endpoints {int((alive & ends).sum())}, keyframe ATE {float(rmse)} m over "
          f"{len(ts)} keyframes", flush=True)


if __name__ == "__main__":
    main()
