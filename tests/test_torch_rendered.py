"""The port's numpy renderer against the JAX package's numpy backend: the
same seeds give the same textures, rays, trajectories, frames and ground
truth, exactly (numpy against numpy)."""

import numpy as np
import pytest

from ccm_slam_tpu.config import scaled_camera as j_scaled_camera
from ccm_slam_tpu.io import rendered as jr
from ccm_slam_tpu_torch.config import scaled_camera
from ccm_slam_tpu_torch.io import rendered as tr


def test_texture_and_rays_match():
    for seed, (h, w) in ((0, (64, 96)), (1, (40, 200))):
        np.testing.assert_array_equal(tr.make_texture(np.random.RandomState(seed), h, w),
                                      jr.make_texture(np.random.RandomState(seed), h, w))
    cam, jcam = scaled_camera(factor=0.1), j_scaled_camera(factor=0.1)
    for ss in (1, 2):
        np.testing.assert_array_equal(tr.pixel_rays(cam, ss), jr.pixel_rays(jcam, ss))


@pytest.mark.parametrize("world", ["corridor", "loop"])
def test_trajectories_match(world):
    ours = getattr(tr, f"{world}_trajectory")(50, 20.0, (0.0, 0.3))
    ref = getattr(jr, f"{world}_trajectory")(50, 20.0, (0.0, 0.3))
    for (t, o, R), (t_r, o_r, R_r) in zip(ours, ref):
        assert t == t_r
        np.testing.assert_array_equal(o, o_r)
        np.testing.assert_array_equal(R, R_r)


def test_corridor_frames_and_ground_truth_match():
    kw = dict(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22))
    ours = tr.RenderedSequence(cam=scaled_camera(factor=0.1), **kw)
    ref = jr.RenderedSequence(cam=j_scaled_camera(factor=0.1), backend="numpy", **kw)
    for i in (0, 6, 150):
        img = ours.render_frame(i)
        assert img.shape == (48, 75) and img.dtype == np.float32
        np.testing.assert_array_equal(img, ref.render_frame(i))
    for a, b in zip(ours.ground_truth(), ref.ground_truth()):
        np.testing.assert_array_equal(a, b)
    frames = list(ours.frames(start=0.2, limit=2))
    assert [f.timestamp for f in frames] == [0.2, 0.25]
    np.testing.assert_array_equal(frames[0].image, ref.render_frame(4))
    t, o, R = ours.gt_pose(6)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    with pytest.raises(ValueError):
        tr.RenderedSequence(world="maze").render_frame(0)


def test_torch_raycaster_matches_jax_raycaster_and_numpy_frames():
    """The torch backend against the reference's XLA raycaster (before the
    sensor model: max 0.05, mean 1e-3 grey levels) and against the numpy
    frames (after 8-bit quantization: at most 0.5% of pixels off, by 1)."""
    import torch

    kw = dict(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22))
    cam = scaled_camera(factor=0.15)
    ours = tr.RenderedSequence(cam=cam, backend="torch", device="cpu", **kw)
    num = tr.RenderedSequence(cam=cam, **kw)
    planes, traj, rays = num._setup()
    run_t = tr.make_raycaster_torch(planes, rays, 2, "cpu")
    run_j = jr.make_raycaster_jax(planes, rays, ss=2)
    for i in (0, 6, 150):
        _, o, R = traj[i]
        d = np.abs(run_t(R, o).numpy() - np.asarray(run_j(R, o)))
        assert d.max() <= 0.05 and d.mean() <= 1e-3, (i, d.max(), d.mean())
        img = ours.render_frame(i)
        assert isinstance(img, torch.Tensor) and img.dtype == torch.float32
        diff = np.abs(img.numpy() - num.render_frame(i))
        assert diff.max() <= 1.0 and (diff > 0).mean() <= 0.005, (i, (diff > 0).mean())
    with pytest.raises(ValueError):
        tr.RenderedSequence(cam=cam, backend="opengl", **kw).render_frame(0)


def test_frame_cache_is_shared_with_jax(tmp_path):
    """``cache_dir``: the port and the JAX package write the same files
    (names and bytes) for the same frames, and each reads the other's back.
    As in the reference, a cache hit returns the stored uint8 image as
    float32 (the render that filled the cache returned it unquantized)."""
    import torch

    kw = dict(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22))
    cam, jcam = scaled_camera(factor=0.1), j_scaled_camera(factor=0.1)
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "jax"
    ours = tr.RenderedSequence(cam=cam, cache_dir=str(ours_dir), **kw)
    ref = jr.RenderedSequence(cam=jcam, backend="numpy", cache_dir=str(ref_dir), **kw)
    fresh = {i: ours.render_frame(i) for i in (0, 6)}
    for i in fresh:
        ref.render_frame(i)

    def files(d):
        return sorted(str(p.relative_to(d)) for p in d.rglob("*"))

    assert files(ours_dir) == files(ref_dir) and len(files(ours_dir)) == 3  # a key dir, 2 frames
    for f in files(ours_dir):
        if f.endswith(".npy"):
            assert (ours_dir / f).read_bytes() == (ref_dir / f).read_bytes(), f
    # each package reads the other's cache: the uint8 frames, not a new render
    ours_on_ref = tr.RenderedSequence(cam=cam, cache_dir=str(ref_dir), **kw)
    ref_on_ours = jr.RenderedSequence(cam=jcam, backend="numpy", cache_dir=str(ours_dir), **kw)
    for i, img in fresh.items():
        a, b = ours_on_ref.render_frame(i), ref_on_ours.render_frame(i)
        assert a.dtype == np.float32 and b.dtype == np.float32
        np.testing.assert_array_equal(a, img.astype(np.uint8).astype(np.float32))
        np.testing.assert_array_equal(a, b)
    marked = np.full(fresh[6].shape, 7, np.uint8)
    np.save(ours_on_ref._cache_path(6), marked)  # a frame no renderer makes
    np.save(ref_on_ours._cache_path(6), marked)
    np.testing.assert_array_equal(ref_on_ours.render_frame(6), marked)
    np.testing.assert_array_equal(ours_on_ref.render_frame(6), marked)
    on_torch = tr.RenderedSequence(cam=cam, backend="torch", device="cpu",
                                   cache_dir=str(ref_dir), **kw).render_frame(6)
    assert isinstance(on_torch, torch.Tensor) and on_torch.dtype == torch.float32
    np.testing.assert_array_equal(on_torch.numpy(), marked)
