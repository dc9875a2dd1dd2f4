"""The port's client mapping stages against the JAX package's, on a small
client map (``problems.client_map_arrays``, tiny_test_config) handed to both
packages as the same arrays.

Tolerances: counts, flags and links equal; triangulated and fused landmark
positions within 1e-4 (float32 SVD and sums in another order); local BA held
to the BA bounds of __graft_entry__.py:144-148 (cost within 5% + 1e-3,
camera centres within 5 mm), with at most 0.5% of its forward links (the
chi2 outlier cut on the moved state) differing, at K=16 and K=32 slots."""

import jax.numpy as jnp
import numpy as np
import pytest

from ccm_slam_tpu.config import tiny_test_config as j_tiny
from ccm_slam_tpu.models import map_store as jms
from ccm_slam_tpu.runtime import mapping as jmap
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import convert, problems
from ccm_slam_tpu_torch.config import tiny_test_config
from ccm_slam_tpu_torch.models import map_store as ms
from ccm_slam_tpu_torch.ops import ba_kernels
from ccm_slam_tpu_torch.runtime import mapping
from ccm_slam_tpu_torch.utils.camera import Camera

CFG, JCFG = tiny_test_config(), j_tiny()


def jax_map(fields):
    return jms.MapState(
        kfs=jms.KeyFrameStore(**{k: jnp.asarray(v) for k, v in fields["kfs"].items()}),
        mps=jms.MapPointStore(**{k: jnp.asarray(v) for k, v in fields["mps"].items()}),
        next_kf=jnp.int32(fields["next_kf"]), next_mp=jnp.int32(fields["next_mp"]),
        insert_counter=jnp.int32(fields["insert_counter"]))


def cams():
    cfg = CFG.camera.__class__(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    jcfg = JCFG.camera.__class__(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    return Camera.from_config(cfg, "cpu"), JCamera.from_config(jcfg)


def prepared(max_obs=16, seed=7, duplicates=0):
    """Map fields after update_normal_and_depth + distinctive descriptors,
    with ``duplicates`` planted landmark copies: a landmark p seen by
    keyframes 4 and 5 gets a twin q (same geometry and descriptor) that
    replaces p's link in keyframe 4, so fusing into keyframe 5 must merge."""
    fields, _, _ = problems.client_map_arrays(max_obs=max_obs, seed=seed)
    kfs, mps = fields["kfs"], fields["mps"]
    q = int(fields["next_mp"])
    for f4 in np.where(kfs["mp_idx"][4] >= 0)[0]:
        if duplicates == 0:
            break
        p = int(kfs["mp_idx"][4, f4])
        if p not in kfs["mp_idx"][5]:
            continue
        for name in ("pos", "desc", "normal", "mp_id", "client_id", "valid", "ref_kf"):
            mps[name][q] = mps[name][p]
        mps["ref_kf"][q] = 4
        mps["first_kf_id"][q] = 4
        kfs["mp_idx"][4, f4] = q
        q += 1
        duplicates -= 1
    fields["next_mp"] = np.int32(q)
    m = ms.rebuild_observations(convert.map_state_from_numpy(fields, "cpu"))
    m = ms.compute_distinctive_descriptors(ms.update_normal_and_depth(m, 1.2, 4))
    assert ms.check_structure(m) == []
    return convert.map_state_to_numpy(m)


def same_map(ours, ref, pos_atol=1e-4):
    a, b = convert.map_state_to_numpy(ours), convert.map_state_fields(ref)
    for part in ("kfs", "mps"):
        for name, x in a[part].items():
            y = b[part][name]
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=1e-4, atol=pos_atol, err_msg=name)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{part}.{name}")
    assert ms.check_structure(ours) == jms.check_structure(ref)


def test_cull_mappoints():
    fields = prepared()
    rng = np.random.RandomState(0)
    M = fields["mps"]["valid"].shape[0]
    fields["mps"]["n_visible"] = rng.randint(1, 9, M).astype(np.int32)
    fields["mps"]["n_found"] = rng.randint(0, 4, M).astype(np.int32)
    m, n = mapping.cull_mappoints(convert.map_state_from_numpy(fields, "cpu"), 2, CFG)
    jm, jn = jmap.cull_mappoints(jax_map(fields), jnp.int32(2), JCFG)
    assert int(n) == int(jn) > 0
    same_map(m, jm)


def test_triangulate_new_points():
    fields = prepared()
    cam, jcam = cams()
    m, n = mapping.triangulate_new_points(convert.map_state_from_numpy(fields, "cpu"), 5, cam,
                                          CFG)
    jm, jn = jmap.triangulate_new_points(jax_map(fields), jnp.int32(5), jcam, JCFG)
    assert int(n) == int(jn) > 10
    same_map(m, jm)


def test_fuse_neighbors_merges_duplicates():
    fields = prepared(duplicates=6)
    cam, jcam = cams()
    m, n_add, n_merge, redir = mapping.fuse_neighbors(
        convert.map_state_from_numpy(fields, "cpu"), 5, cam, CFG)
    jm, jn_add, jn_merge, jredir = jmap.fuse_neighbors(jax_map(fields), jnp.int32(5), jcam, JCFG)
    assert (int(n_add), int(n_merge)) == (int(jn_add), int(jn_merge))
    assert int(n_merge) >= 5  # of the 6 planted twins
    np.testing.assert_array_equal(redir.numpy(), np.asarray(jredir))
    same_map(m, jm)


@pytest.mark.parametrize("max_obs", [16, 32])
def test_local_ba(max_obs):
    fields = prepared(max_obs=max_obs)
    rng = np.random.RandomState(max_obs)
    fields["kfs"]["t_cw"][2:6] += rng.randn(4, 3).astype(np.float32) * 0.01
    fields["mps"]["pos"] += rng.randn(*fields["mps"]["pos"].shape).astype(np.float32) * 0.02
    cam, jcam = cams()
    m0 = convert.map_state_from_numpy(fields, "cpu")
    ba_kernels.reset_launch_counts()
    m, cost, n_good, n_trunc = mapping.local_ba(m0, 5, cam, CFG)
    assert all(n == 0 for n in ba_kernels.launch_counts().values())  # CPU: plain versions
    jm, jcost, jn_good, jn_trunc = jmap.local_ba(jax_map(fields), jnp.int32(5), jcam, JCFG)
    assert int(n_trunc) == int(jn_trunc)
    cost, jcost = float(cost), float(jcost)
    assert abs(cost - jcost) <= 0.05 * jcost + 1e-3, (cost, jcost)
    ctr = ms.KeyFrameStore.center(m.kfs).numpy()
    jctr = -np.einsum("kij,ki->kj", np.asarray(jm.kfs.R_cw), np.asarray(jm.kfs.t_cw))
    assert np.linalg.norm(ctr - jctr, axis=-1).max() < 5e-3
    # only the free keyframes moved, the two oldest (the gauge) did not
    moved = np.asarray(m.kfs.pose_version.numpy())
    np.testing.assert_array_equal(moved, np.asarray(jm.kfs.pose_version))
    assert moved[:2].sum() == 0 and moved[5] == 1
    links, jlinks = m.kfs.mp_idx.numpy(), np.asarray(jm.kfs.mp_idx)
    assert (links != jlinks).mean() <= 0.005
    assert ms.check_structure(m) == []
