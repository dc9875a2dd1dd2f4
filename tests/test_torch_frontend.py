"""The port's front-end (config, camera, resize, FAST, BRIEF, ORB, Frame)
against the JAX package on the CPU, on the same seeded numpy inputs.

Tolerances, with the worst case measured on these inputs beside each:
  * config copies, FAST on an integer-valued image, budgets, shapes and the
    BRIEF pattern: exact;
  * the pyramid resize: <= 1e-4 absolute on a 0..255 image (measured 6.1e-5);
  * camera undistortion: <= 1e-3 px (measured 1.2e-4); build_frame xy:
    <= 1e-3 px (measured 1.5e-5);
  * BRIEF bits on the same angles: mean Hamming <= 0.5 bit (measured 0);
  * orb.extract (120x160, 3 levels, 128 features): valid/octave/xy equal on
    >= 99% of slots (measured 100%), descriptors bit-exact on >= 99% of
    shared keypoints (measured 99.2%: one descriptor of 128 differs) with
    mean Hamming <= 0.5 bit (measured 0.008), angle within 1e-4 rad
    (measured 8.8e-6).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu import config as jconfig
from ccm_slam_tpu.ops import brief as jbrief, fast as jfast, orb as jorb
from ccm_slam_tpu.runtime.frame import build_frame as j_build_frame
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import config as tconfig, convert
from ccm_slam_tpu_torch.ops import brief as tbrief, fast as tfast, hamming as thamming
from ccm_slam_tpu_torch.ops import orb as torb
from ccm_slam_tpu_torch.runtime.frame import NO_MP, build_frame as t_build_frame
from ccm_slam_tpu_torch.utils.camera import Camera as TCamera

CPU = "cpu"


def texture(h, w, seed, integer=True):
    """Smoothed uniform noise, 0..255 (5x5 box blur by cumulative sums)."""
    img = np.random.RandomState(seed).rand(h + 4, w + 4) * 255.0
    c = np.cumsum(np.cumsum(np.pad(img, ((1, 0), (1, 0))), 0), 1)
    img = (c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5]) / 25.0
    return (np.round(img) if integer else img).astype(np.float32)


@pytest.mark.parametrize("section", ["ExtractorConfig", "CameraConfig"])
def test_config_copies_match(section):
    ours, ref = getattr(tconfig, section)(), getattr(jconfig, section)()
    ref_fields = {f.name for f in dataclasses.fields(ref)}
    assert {f.name for f in dataclasses.fields(ours)} <= ref_fields
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name


def test_capacity_and_scaled_camera_match():
    ours, ref = tconfig.CapacityConfig(), jconfig.CapacityConfig()
    assert ours.max_keypoints == ref.max_keypoints
    assert ours.client_max_mps == ref.client_max_mps
    for factor in (0.25, 0.4, 1.0):
        ours, ref = tconfig.scaled_camera(factor=factor), jconfig.scaled_camera(factor=factor)
        for name, value in dataclasses.asdict(ours).items():
            assert value == getattr(ref, name), name


def test_camera_matches_jax():
    cfg = tconfig.CameraConfig()
    ours, ref = TCamera.from_config(cfg, CPU), JCamera.from_config(jconfig.CameraConfig())
    np.testing.assert_allclose(ours.bounds.numpy(), np.asarray(ref.bounds), atol=1e-3)
    np.testing.assert_allclose(ours.K.numpy(), np.asarray(ref.K), rtol=0, atol=0)
    rng = np.random.default_rng(0)
    uv = (rng.random((500, 2)) * [cfg.width, cfg.height]).astype(np.float32)
    xc = np.concatenate([rng.normal(size=(500, 2)), rng.uniform(1, 9, (500, 1))], 1)
    xc = xc.astype(np.float32)

    @jax.jit
    def ref_fns(uv, xc):
        und = ref.undistort_pixels(uv)
        return und, ref.project(xc), ref.backproject(uv, xc[:, 2]), ref.in_bounds(und)

    ref_out = [np.asarray(a) for a in ref_fns(jnp.asarray(uv), jnp.asarray(xc))]
    u, x = torch.tensor(uv), torch.tensor(xc)
    und = ours.undistort_pixels(u)
    np.testing.assert_allclose(und.numpy(), ref_out[0], atol=1e-3)
    np.testing.assert_allclose(ours.project(x).numpy(), ref_out[1], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(ours.backproject(u, x[:, 2]).numpy(), ref_out[2], rtol=1e-6,
                               atol=1e-5)
    # a point exactly on a bound may land on either side of it
    assert (ours.in_bounds(und).numpy() == ref_out[3]).mean() >= 0.99


@pytest.mark.parametrize("shape", [(100, 157), (83, 131), (40, 50)])
def test_resize_matches_jax_image_resize(shape):
    """jax.image.resize antialiases on downscale; F.interpolate would not match."""
    img = texture(120, 188, 1, integer=False)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), shape, "bilinear"))
    ours = torb.resize_bilinear(torch.tensor(img), shape).numpy()
    assert np.abs(ours - ref).max() <= 1e-4


@pytest.mark.parametrize("sizes", [(120, 100), (480, 400), (752, 627)])
def test_resize_weights_match_jax(sizes):
    """The reference's effective weights (resizing an identity image along
    one axis), which its compiled FMA sample positions set: within 2 ulp of
    1, 2.4e-7 (measured 1.2e-7)."""
    n_in, n_out = sizes
    ref = np.asarray(jax.image.resize(jnp.eye(n_in, dtype=jnp.float32), (n_out, n_in),
                                      "bilinear")).T
    assert np.abs(torb.resize_weights(n_in, n_out) - ref).max() <= 2.4e-7


def test_fast_detect_exact_on_integer_image():
    img = texture(96, 128, 2)
    v_ref, s_ref = jax.jit(jfast.detect)(jnp.asarray(img))
    v, s = tfast.detect(torch.tensor(img))
    assert v.sum() > 50
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_array_equal(tfast.nms3x3(torch.tensor(np.asarray(s_ref))).numpy(),
                                  np.asarray(jax.jit(jfast.nms3x3)(s_ref)))


def test_brief_pattern_and_sampling_match():
    np.testing.assert_array_equal(tbrief.PATTERN, jbrief.PATTERN)
    rng = np.random.default_rng(3)
    img = texture(80, 90, 3, integer=False)
    kp = np.stack([rng.uniform(0, 90, 64), rng.uniform(0, 80, 64)], 1).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    p1, p2 = tbrief.steered_coords(torch.tensor(ang))

    @jax.jit
    def ref_fns(img, kp, ang):
        return jbrief.steered_coords(ang), jbrief.descriptor_bits(img, kp, ang)

    (r1, r2), ref = ref_fns(jnp.asarray(img), jnp.asarray(kp), jnp.asarray(ang))
    np.testing.assert_allclose(p1.numpy(), np.asarray(r1), atol=1e-5)
    np.testing.assert_allclose(p2.numpy(), np.asarray(r2), atol=1e-5)
    ours = tbrief.descriptor_bits(torch.tensor(img), torch.tensor(kp), torch.tensor(ang))
    ref = np.asarray(ref)
    d = thamming.hamming_pairwise(ours, torch.tensor(ref))
    assert float(d.float().mean()) <= 0.5  # a rounding at .5 may flip a bit


def test_blur_and_ic_angle_match():
    img = texture(70, 100, 4, integer=False)
    rng = np.random.default_rng(4)
    kp = np.stack([rng.integers(0, 100, 40), rng.integers(0, 70, 40)], 1).astype(np.float32)
    blur, ang = jax.jit(lambda im, k: (jorb.gaussian_blur(im), jorb.ic_angle(im, k)))(
        jnp.asarray(img), jnp.asarray(kp))
    np.testing.assert_allclose(torb.gaussian_blur(torch.tensor(img)).numpy(), np.asarray(blur),
                               atol=1e-3)
    np.testing.assert_allclose(torb.ic_angle(torch.tensor(img), torch.tensor(kp)).numpy(),
                               np.asarray(ang), atol=1e-4)


@pytest.mark.parametrize("args", [(1000, 8, 1.2), (2000, 8, 1.2), (128, 3, 1.2), (300, 4, 1.3)])
def test_budgets_and_shapes_match(args):
    n, levels, s = args
    assert torb.level_budgets(n, levels, s) == jorb.level_budgets(n, levels, s)
    assert torb.level_shapes(480, 752, levels, s) == jorb.level_shapes(480, 752, levels, s)


@pytest.fixture(scope="module")
def extracted():
    img = texture(120, 160, 5)
    kw = dict(n_features=128, n_levels=3, scale_factor=1.2, capacity=128)
    ref = jorb.extract(jnp.asarray(img), **kw)
    ours = torb.extract(torch.tensor(img), **kw)
    return ours, ref


def test_orb_extract_matches_jax(extracted):
    ours, ref = extracted
    valid, v_ref = ours.valid.numpy(), np.asarray(ref.valid)
    assert v_ref.sum() > 100
    assert (valid == v_ref).mean() >= 0.99
    assert (ours.octave.numpy() == np.asarray(ref.octave)).mean() >= 0.99
    same_xy = np.all(ours.xy.numpy() == np.asarray(ref.xy), axis=1)
    assert same_xy.mean() >= 0.99
    shared = valid & v_ref & same_xy
    dist = thamming.hamming_pairwise(ours.desc, torch.tensor(np.asarray(ref.desc))).numpy()
    assert (dist[shared] == 0).mean() >= 0.99
    assert dist[shared].mean() <= 0.5
    assert np.abs(ours.angle.numpy() - np.asarray(ref.angle))[shared].max() <= 1e-4
    np.testing.assert_allclose(ours.response.numpy()[shared], np.asarray(ref.response)[shared],
                               rtol=1e-5, atol=1e-3)


def test_build_frame_matches_jax(extracted):
    ours, ref = extracted
    tcam = TCamera.from_config(tconfig.scaled_camera(factor=0.25), CPU)
    f = t_build_frame(ours, tcam, 1.5)
    jcam = JCamera.from_config(jconfig.scaled_camera(factor=0.25))
    g = jax.jit(lambda feats: j_build_frame(feats, jcam, 1.5))(ref)
    v = f.valid.numpy() & np.asarray(g.valid)
    assert np.abs(f.xy.numpy() - np.asarray(g.xy))[v].max() <= 1e-3
    # the JAX package's own features carried across (convert): the same frame
    h = t_build_frame(convert.features_from_numpy(convert.feature_fields(ref), CPU), tcam, 1.5)
    assert np.abs(h.xy.numpy() - np.asarray(g.xy)).max() <= 1e-3
    np.testing.assert_array_equal(h.desc.numpy(), np.asarray(g.desc))
    np.testing.assert_array_equal(f.sigma2.numpy(), np.asarray(g.sigma2))
    assert float(f.timestamp) == float(g.timestamp)
    assert torch.equal(f.R_cw, torch.eye(3)) and torch.all(f.mp == NO_MP)
    assert int(f.n) == int(g.n)
