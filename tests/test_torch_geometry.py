"""The port's two-view initializer and RANSAC-PnP against the JAX package
on the CPU, with the RANSAC samples the JAX key draws fed to the port, and
the front-end slice as a whole on a small rendered pair.

SVD signs differ between LAPACK builds, so the candidate order of the E/H
decompositions may differ: the chosen motion is compared, never an index.
Tolerances, with the worst case measured on these inputs beside each:
  * initialize_two_view: success and used_h equal; R, t within 1e-4
    (measured 2.8e-6 and 7.2e-5); good equal on >= 99.5% of slots (measured
    100%); X within 1e-3 relative where good in both (measured 3.9e-5);
  * ransac_pnp: success equal; R, t within 1e-4 (measured 1.6e-6 and
    6.3e-6); inliers equal on >= 99% (measured 100%);
  * the slice (extract -> build_frame -> search_for_initialization ->
    initialize_two_view): success equal, R within 1e-3 (measured 5.0e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import scaled_camera as j_scaled_camera
from ccm_slam_tpu.ops import initializer as ji, matching as jm, orb as jorb, pnp as jpnp
from ccm_slam_tpu.runtime.frame import build_frame as j_build_frame
from ccm_slam_tpu.utils import lie as jlie
from ccm_slam_tpu.utils.camera import Camera as JCamera
from ccm_slam_tpu_torch import config as tconfig, convert
from ccm_slam_tpu_torch.io.rendered import RenderedSequence
from ccm_slam_tpu_torch.ops import initializer as ti, matching as tm, orb as torb, pnp as tpnp
from ccm_slam_tpu_torch.runtime.frame import build_frame as t_build_frame
from ccm_slam_tpu_torch.utils.camera import Camera as TCamera

FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375
K = np.array([[FX, 0, CX], [0, FY, CY], [0, 0, 1.0]], np.float32)
T = torch.tensor
J = jnp.asarray

j_init2 = jax.jit(ji.initialize_two_view)


def init_indices(key, valid, n=200):
    """The samples initialize_two_view draws from ``key``."""
    kf, kh = jax.random.split(key)
    logits = jnp.log(J(valid).astype(jnp.float32) + 1e-12)
    return (T(np.asarray(jax.random.categorical(kf, logits, shape=(n, 8)))),
            T(np.asarray(jax.random.categorical(kh, logits, shape=(n, 4)))))


def pnp_indices(key, valid, n=200):
    logits = jnp.log(J(valid).astype(jnp.float32) + 1e-12)
    return T(np.asarray(jax.random.categorical(key, logits, shape=(n, 6))))


def two_view_scene(seed, n=256, planar=False, noise=0.3, rotation_only=False):
    """tests/test_matching.py::TestInitializer's scenes, in numpy (256 slots,
    the slice test's shape, so the JAX function compiles once)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, 3))
    if planar:
        X[:, 2] = 0.0
    X[:, 2] += 8.0
    xi = np.array([0.0, 0.0, 0.0, 0.0, 0.1, 0.02]) if rotation_only else \
        np.array([0.8, 0.1, 0.05, 0.02, -0.08, 0.01])
    R, t = _se3(xi)
    if rotation_only:
        t = np.zeros(3)
    x1 = X @ K.T
    p1 = x1[:, :2] / x1[:, 2:3]
    Xc = X @ R.T + t
    x2 = Xc @ K.T
    p2 = x2[:, :2] / x2[:, 2:3]
    p1 = p1 + rng.normal(0, noise, p1.shape)
    p2 = p2 + rng.normal(0, noise, p2.shape)
    valid = rng.random(n) < 0.95
    return p1.astype(np.float32), p2.astype(np.float32), valid, R, t


def _se3(xi):
    T_ = jlie.SE3.exp(J(xi, jnp.float32))
    return np.asarray(T_.R, np.float64), np.asarray(T_.t, np.float64)


def compare_init(ours, ref):
    assert bool(ours["success"]) == bool(ref["success"])
    assert bool(ours["used_h"]) == bool(ref["used_h"])
    np.testing.assert_allclose(ours["R"].numpy(), np.asarray(ref["R"]), atol=1e-4)
    np.testing.assert_allclose(ours["t"].numpy(), np.asarray(ref["t"]), atol=1e-4)
    good, g_ref = ours["good"].numpy(), np.asarray(ref["good"])
    assert (good == g_ref).mean() >= 0.995
    both = good & g_ref
    X, X_ref = ours["X"].numpy()[both], np.asarray(ref["X"])[both]
    rel = np.linalg.norm(X - X_ref, axis=-1) / np.linalg.norm(X_ref, axis=-1)
    assert rel.max(initial=0.0) <= 1e-3


@pytest.mark.parametrize("scene", ["general", "planar", "rotation_only"])
def test_initialize_two_view_matches_jax(scene):
    p1, p2, valid, R_gt, t_gt = two_view_scene(
        6, planar=scene == "planar", rotation_only=scene == "rotation_only")
    key = jax.random.PRNGKey(7)
    ref = j_init2(key, J(p1), J(p2), J(valid), J(K))
    idx_f, idx_h = init_indices(key, valid)
    ours = ti.initialize_two_view(T(p1), T(p2), T(valid), T(K), idx_f=idx_f, idx_h=idx_h)
    compare_init(ours, ref)
    if scene == "rotation_only":
        assert not bool(ours["success"])
    else:
        assert bool(ours["success"]) and bool(ours["used_h"]) == (scene == "planar")
        t_dir = ours["t"].numpy() / np.linalg.norm(ours["t"].numpy())
        assert abs(float(t_dir @ t_gt) / np.linalg.norm(t_gt)) > 0.99


def test_initialize_two_view_draws_from_a_generator():
    p1, p2, valid, _, t_gt = two_view_scene(8)
    gen = torch.Generator().manual_seed(3)
    a = ti.initialize_two_view(T(p1), T(p2), T(valid), T(K), generator=gen)
    b = ti.initialize_two_view(T(p1), T(p2), T(valid), T(K),
                               generator=torch.Generator().manual_seed(3))
    assert bool(a["success"]) and torch.equal(a["R"], b["R"])
    idx = ti.draw_samples(T(valid), 50, 8, torch.Generator().manual_seed(0))
    assert idx.shape == (50, 8) and bool(T(valid)[idx].all())


def test_triangulate_and_decompositions_match_jax():
    R, t = _se3(np.array([0.5, 0.0, 0.0, 0.0, 0.05, 0.0]))
    X = np.array([[0.3, -0.2, 6.0], [1.0, 0.5, 4.0]])
    P1 = K @ np.hstack([np.eye(3), np.zeros((3, 1))])
    P2 = K @ np.hstack([R, t[:, None]])
    p1 = (X @ K.T)[:, :2] / X[:, 2:3]
    x2 = (X @ R.T + t) @ K.T
    p2 = x2[:, :2] / x2[:, 2:3]
    args = [a.astype(np.float32) for a in (P1, P2, p1, p2)]
    E = (np.asarray(jlie.hat(J(t, jnp.float32))) @ R).astype(np.float32)
    ref_X, ref_E = jax.jit(lambda a, e: (ji.triangulate(*a), ji._decompose_e(e)))(
        [J(a) for a in args], J(E))
    ours_X = ti.triangulate(*[T(a) for a in args]).numpy()
    np.testing.assert_allclose(ours_X, X, atol=1e-3)
    np.testing.assert_allclose(ours_X, np.asarray(ref_X), atol=1e-4)
    # the candidate sets agree as sets (their order follows the SVD signs)
    R1, R2, tE = (a.numpy() for a in ti._decompose_e(T(E)))
    r1, r2, te = (np.asarray(a) for a in ref_E)
    assert {np.round(R1, 4).tobytes(), np.round(R2, 4).tobytes()} == \
        {np.round(r1, 4).tobytes(), np.round(r2, 4).tobytes()}
    assert np.allclose(np.abs(tE @ te), 1.0, atol=1e-5)


def pnp_scene(seed, n=150):
    """tests/test_matching.py::TestPnP's scene, in numpy: 25 gross outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (n, 3))
    X[:, 2] += 9.0
    R, t = _se3(np.array([0.4, -0.2, 0.6, 0.1, -0.15, 0.08]))
    Xc = X @ R.T + t
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + CX, FY * Xc[:, 1] / Xc[:, 2] + CY], -1)
    uv = uv + rng.normal(0, 0.3, uv.shape)
    uv[:25] += 80.0
    sigma2 = rng.choice([1.0, 1.44], n)
    valid = rng.random(n) < 0.97
    return [a.astype(np.float32) for a in (X, uv, sigma2)] + [valid, R, t]


@pytest.mark.parametrize("refine", [True, False])
def test_ransac_pnp_matches_jax(refine):
    X, uv, sigma2, valid, R_gt, t_gt = pnp_scene(20)
    key = jax.random.PRNGKey(22)
    ref = jax.jit(jpnp.ransac_pnp, static_argnames=("refine",))(
        key, J(X), J(uv), J(valid), J(sigma2), FX, FY, CX, CY, refine=refine)
    ours = tpnp.ransac_pnp(T(X), T(uv), T(valid), T(sigma2), FX, FY, CX, CY, refine=refine,
                           idx=pnp_indices(key, valid))
    assert bool(ours["success"]) == bool(ref["success"])
    np.testing.assert_allclose(ours["R"].numpy(), np.asarray(ref["R"]), atol=1e-4)
    np.testing.assert_allclose(ours["t"].numpy(), np.asarray(ref["t"]), atol=1e-4)
    assert (ours["inliers"].numpy() == np.asarray(ref["inliers"])).mean() >= 0.99
    if refine:
        assert bool(ours["success"]) and int(ours["n_inliers"]) > 100
        assert np.linalg.norm(ours["t"].numpy() - t_gt) < 0.02
        assert not bool(ours["inliers"][:25].any())


def test_front_end_slice_matches_jax():
    """Rendered corridor pair at 0.25 scale through both packages' front-end:
    JAX's features and indices drive the JAX path; the port extracts its
    own features and takes the JAX key's RANSAC samples."""
    factor, pair = 0.25, (0, 6)
    cam_cfg = tconfig.scaled_camera(factor=factor)
    seq = RenderedSequence(world="corridor", seed=0, n_frames=200, span=(0.0, 0.22), cam=cam_cfg)
    kw = dict(n_features=256, n_levels=3, scale_factor=1.2, cell=16, capacity=256)
    jcam = JCamera.from_config(j_scaled_camera(factor=factor))
    tcam = TCamera.from_config(cam_cfg, "cpu")

    j_frame = jax.jit(lambda im: j_build_frame(jorb.extract(im, **kw), jcam, 0.0))
    imgs = [seq.render_frame(i) for i in pair]  # equal to the JAX renderer's (test_torch_rendered)
    f1, f2 = (j_frame(J(im)) for im in imgs)
    idx, _, ok = jax.jit(jm.search_for_initialization)(
        f1.xy, f1.desc, f1.valid, f1.angle, f1.octave, f2.xy, f2.desc, f2.valid, f2.angle,
        f2.octave)
    key = jax.random.PRNGKey(1)
    ref = j_init2(key, f1.xy, f2.xy[idx], ok, jcam.K)

    g1, g2 = (t_build_frame(torb.extract(T(im), **kw), tcam, 0.0) for im in imgs)
    assert (np.abs(g1.xy.numpy() - np.asarray(f1.xy)).max(axis=1) <= 1e-3).mean() >= 0.99
    t_idx, _, t_ok = tm.search_for_initialization(
        g1.xy, g1.desc, g1.valid, g1.angle, g1.octave, g2.xy, g2.desc, g2.valid, g2.angle,
        g2.octave)
    assert (t_ok.numpy() == np.asarray(ok)).mean() >= 0.99
    idx_f, idx_h = init_indices(key, np.asarray(ok))
    ours = ti.initialize_two_view(g1.xy, g2.xy[t_idx], t_ok, tcam.K, idx_f=idx_f, idx_h=idx_h)
    assert bool(ref["success"]) and bool(ours["success"])
    np.testing.assert_allclose(ours["R"].numpy(), np.asarray(ref["R"]), atol=1e-3)
    # the same step fed the JAX package's own frames (convert) agrees tighter
    h1, h2 = (convert.frame_from_numpy(convert.frame_fields(f), "cpu") for f in (f1, f2))
    c_idx, _, c_ok = tm.search_for_initialization(
        h1.xy, h1.desc, h1.valid, h1.angle, h1.octave, h2.xy, h2.desc, h2.valid, h2.angle,
        h2.octave)
    np.testing.assert_array_equal(c_ok.numpy(), np.asarray(ok))
    np.testing.assert_array_equal(c_idx.numpy()[c_ok.numpy()], np.asarray(idx)[np.asarray(ok)])
