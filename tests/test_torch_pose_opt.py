"""Parity of the port's pose-only LM (the tracking step) with the JAX
package on the CPU: R and t within 1e-4, the same inlier set."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ccm_slam_tpu.solvers import pose_opt as jpose
from ccm_slam_tpu_torch import problems
from ccm_slam_tpu_torch.solvers import pose_opt as tpose

FX, FY, CX, CY = problems.INTRINSICS


def _case(name):
    arr = problems.tracking_arrays(512, seed={"entry": 0, "outliers": 1, "masked": 2}[name])
    rng = np.random.default_rng(3)
    if name == "outliers":  # 10% gross mismatches: re-classification must drop them
        bad = rng.random(512) < 0.1
        arr["uv"] = np.where(bad[:, None], arr["uv"] + rng.uniform(20, 60, (512, 2)),
                             arr["uv"]).astype(np.float32)
    if name == "masked":  # empty slots and mixed pyramid levels
        arr["valid"] = rng.random(512) > 0.2
        arr["sigma2"] = (1.44 ** rng.integers(0, 4, 512)).astype(np.float32)
    return arr


@pytest.mark.parametrize("name", ["entry", "outliers", "masked"])
def test_optimize_pose_matches_jax(name):
    arr = _case(name)
    Rj, tj, inl_j, n_j = jpose.optimize_pose(*(jnp.asarray(arr[k]) for k in arr),
                                             FX, FY, CX, CY)
    Rt, tt, inl_t, n_t = tpose.optimize_pose(*(torch.as_tensor(arr[k]) for k in arr),
                                             FX, FY, CX, CY)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4)
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j)
    if name == "outliers":
        assert int(n_t) < 480  # the gross mismatches were rejected


def test_tracking_arrays_match_graft_entry():
    ours = problems.tracking_arrays()
    ref = graft._synthetic_tracking_args()
    assert len(ours) == len(ref)
    for (name, a), b in zip(ours.items(), ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
