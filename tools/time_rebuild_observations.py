"""Time ``map_store.rebuild_observations`` against its previous form on the card.

    python3 tools/time_rebuild_observations.py

The arena is the loop closer's (phase 12 of ``chip_smoke.py``,
``rendered_ci_config(1.0)``): 160 keyframe slots of 1,024 feature slots,
24,576 landmark slots of 16 observation slots; 136 keyframes alive, each
linking ~600 features to landmarks of a sliding window (so landmarks near
the window's middle overflow their 16 slots, as a fusion leaves them).
The previous form wrote every lane with an accumulating ``index_put``, the
no-op lanes all on slot (0, 0); the current one writes those lanes to
spare rows with a plain ``index_put``.  Both must give the same integers.
Prints one JSON line: each form's device ms per call (``torch.profiler``
over 20 calls, CUDA-event ms beside it), its device kernels per call, and
the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ccm_slam_tpu_torch.models import map_store as ms  # noqa: E402
from tools.kernel_timing import device_events, event_ms  # noqa: E402

K, N, M, O = 160, 1024, 24576, 16
REPS = 20


def rebuild_colliding(m):
    """``rebuild_observations`` before it wrote spare rows: accumulating
    scatters over every lane, the no-op lanes all on slot (0, 0)."""
    kfs, mps = m.kfs, m.mps
    K, N = kfs.capacity, kfs.n_feat
    O, M = mps.max_obs, mps.capacity
    dev = kfs.mp_idx.device

    def add(x, index, delta):
        return x.index_put(tuple(i.long() for i in index), delta.to(x.dtype), accumulate=True)

    live = ((kfs.mp_idx.reshape(-1) >= 0)
            & torch.repeat_interleave(kfs.valid & ~kfs.bad, N) & kfs.feat_valid.reshape(-1))
    mp_key = torch.where(live, kfs.mp_idx.reshape(-1).long(), M)
    order = torch.argsort(mp_key, stable=True)
    sorted_mp = mp_key[order]
    first_of = torch.searchsorted(sorted_mp, torch.arange(M + 1, device=dev))
    rank = torch.arange(K * N, device=dev) - first_of[sorted_mp.clamp(0, M)]
    src_kf, src_feat = (order // N).to(torch.int32), (order % N).to(torch.int32)
    write = (sorted_mp < M) & (rank < O)
    tgt = (torch.where(write, sorted_mp, 0), torch.where(write, rank, 0))
    obs_kf = add(torch.full((M, O), -1, dtype=torch.int32, device=dev), tgt,
                 torch.where(write, src_kf + 1, 0))
    obs_feat = add(torch.zeros(M, O, dtype=torch.int32, device=dev), tgt,
                   torch.where(write, src_feat, 0))
    obs_n = add(torch.zeros(M, dtype=torch.int32, device=dev), (tgt[0],), write.to(torch.int32))
    overflow = live[order] & (sorted_mp < M) & (rank >= O)
    dk, df = torch.where(overflow, src_kf, 0).long(), torch.where(overflow, src_feat, 0).long()
    mp_idx2 = add(kfs.mp_idx, (dk, df), torch.where(overflow, -1 - kfs.mp_idx[dk, df], 0))
    return m.replace(kfs=kfs.replace(mp_idx=mp_idx2),
                     mps=mps.replace(obs_kf=obs_kf, obs_feat=obs_feat, obs_n=obs_n))


def arena(dev):
    rng = np.random.default_rng(0)
    m = ms.empty_map(K, M, N, O, dev)
    mp_idx = np.full((K, N), -1, np.int32)
    for k in range(136):
        lo = k * 40
        feats = rng.choice(N, 600, replace=False)
        mp_idx[k, feats] = rng.choice(np.arange(lo, lo + 800) % M, 600, replace=False)
    alive = np.arange(K) < 136
    kfs = m.kfs.replace(mp_idx=torch.as_tensor(mp_idx, device=dev),
                        valid=torch.as_tensor(alive, device=dev),
                        feat_valid=torch.as_tensor(rng.random((K, N)) < 0.97, device=dev))
    return m.replace(kfs=kfs)


def timed(fn, dev):
    fn()
    torch.cuda.synchronize(dev)
    device, _ = device_events(lambda: [fn() for _ in range(REPS)])
    busy = sum(e.self_device_time_total for e in device) / 1e3 / REPS
    return dict(device_ms=busy, events_ms=event_ms(fn, REPS),
                kernels_per_call=sum(e.count for e in device) / REPS)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_rebuild_observations: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    m = arena(dev)
    new, old = ms.rebuild_observations(m), rebuild_colliding(m)
    same = all(torch.equal(getattr(new.mps, f), getattr(old.mps, f))
               for f in ("obs_kf", "obs_feat", "obs_n")) and torch.equal(new.kfs.mp_idx,
                                                                         old.kfs.mp_idx)
    overflowed = int((old.mps.obs_n == O).sum())
    out = dict(same_integers=same, landmarks_at_capacity=overflowed,
               spare_rows=timed(lambda: ms.rebuild_observations(m), dev),
               colliding=timed(lambda: rebuild_colliding(m), dev))
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
