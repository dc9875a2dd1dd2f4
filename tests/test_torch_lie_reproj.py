"""Parity of the port's Lie-group and reprojection functions with the JAX
package, on the CPU, from the same numpy inputs.

Tolerance: atol 1e-5 plus rtol 1e-6 (a few float32 ulps of the value); logs
(an inverse, ill-conditioned near 0 and pi) and pixel residuals (a
difference of two ~700 px values) get the atol named where they are
compared."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.solvers import reproj as jreproj
from ccm_slam_tpu.utils import lie as jlie
from ccm_slam_tpu_torch.solvers import reproj as treproj
from ccm_slam_tpu_torch.utils import lie as tlie

ATOL, RTOL = 1e-5, 1e-6
FX, FY, CX, CY = 458.654, 457.296, 367.215, 248.375


def close(ours, ref, atol=ATOL):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=RTOL, atol=atol)


def both(x):
    x = np.asarray(x, np.float32)
    return jnp.asarray(x), torch.tensor(x)


def from_jax(x):
    """A JAX result as a (writable, copied) torch tensor."""
    return torch.tensor(np.asarray(x))


def rotvecs(scale, n=64, seed=0):
    """Rotation vectors of norm ~scale (0 gives exact zeros)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return (v * scale * rng.uniform(0.5, 1.0, (n, 1))).astype(np.float32)


SCALES = [0.0, 1e-6, 1e-3, 0.5, 2.0, 3.1]


def test_hat_vee():
    j, t = both(rotvecs(1.0))
    close(tlie.hat(t), jlie.hat(j))
    close(tlie.vee(tlie.hat(t)), jlie.vee(jlie.hat(j)))


@pytest.mark.parametrize("scale", SCALES)
def test_so3_exp_log(scale):
    j, t = both(rotvecs(scale, seed=1))
    Rj, Rt = jlie.so3_exp(j), tlie.so3_exp(t)
    close(Rt, Rj)
    close(tlie.so3_log(from_jax(Rj)), jlie.so3_log(Rj), atol=1e-4)


def test_so3_log_near_pi():
    axis = rotvecs(1.0, n=32, seed=2)
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    phi = (axis * (np.pi - np.float32(1e-4))).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(phi)))
    close(tlie.so3_log(torch.as_tensor(R)), jlie.so3_log(jnp.asarray(R)), atol=1e-4)


@pytest.mark.parametrize("scale", SCALES)
def test_se3_exp_log(scale):
    rng = np.random.default_rng(3)
    xi = np.concatenate([rng.standard_normal((64, 3)).astype(np.float32),
                         rotvecs(scale, seed=3)], -1)
    j, t = both(xi)
    (Rj, tj), (Rt, tt) = jlie.se3_exp(j), tlie.se3_exp(t)
    close(Rt, Rj)
    close(tt, tj)
    close(tlie.se3_log(from_jax(Rj), from_jax(tj)),
          jlie.se3_log(Rj, tj), atol=1e-4)


def test_orthonormalize():
    rng = np.random.default_rng(4)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rotvecs(1.0, seed=4))))
    R = (R + rng.standard_normal(R.shape) * 1e-3).astype(np.float32)
    j, t = both(R)
    close(tlie.orthonormalize(t), jlie.orthonormalize(j))


@pytest.mark.parametrize("sigma_scale", [0.0, 1e-6, 0.3])
@pytest.mark.parametrize("scale", [0.0, 1e-3, 1.0])
def test_sim3_exp_log(scale, sigma_scale):
    rng = np.random.default_rng(5)
    n = 64
    xi = np.concatenate([rng.standard_normal((n, 3)).astype(np.float32),
                         rotvecs(scale, n=n, seed=5),
                         (rng.standard_normal((n, 1)) * sigma_scale).astype(np.float32)], -1)
    j, t = both(xi)
    (sj, Rj, tj), (st, Rt, tt) = jlie.sim3_exp(j), tlie.sim3_exp(t)
    close(st, sj)
    close(Rt, Rj)
    close(tt, tj)
    ours = tlie.sim3_log(from_jax(sj), from_jax(Rj), from_jax(tj))
    close(ours, jlie.sim3_log(sj, Rj, tj), atol=1e-4)


def test_quaternions():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((64, 4)).astype(np.float32)
    j, t = both(q)
    close(tlie.quat_to_rot(t), jlie.quat_to_rot(j))
    R = np.asarray(jlie.quat_to_rot(j))
    close(tlie.rot_to_quat(torch.as_tensor(R)), jlie.rot_to_quat(jnp.asarray(R)))


def _se3_pair(seed, n=16):
    rng = np.random.default_rng(seed)
    xi = np.concatenate([rng.standard_normal((n, 3)), rotvecs(1.0, n=n, seed=seed)],
                        -1).astype(np.float32)
    j, t = both(xi)
    return jlie.SE3.exp(j), tlie.SE3.exp(t)


def test_se3_class():
    aj, at = _se3_pair(7)
    bj, bt = _se3_pair(8)
    pts = np.random.default_rng(9).standard_normal((16, 5, 3)).astype(np.float32)
    close(at.compose(bt).R, aj.compose(bj).R)
    close(at.compose(bt).t, aj.compose(bj).t)
    close(at.inverse().t, aj.inverse().t)
    close(at.apply(torch.as_tensor(pts)), aj.apply(jnp.asarray(pts)))
    close(at.matrix(), aj.matrix())
    close(tlie.se3_relative(at, bt).t, jlie.se3_relative(aj, bj).t)
    close(tlie.SE3.identity((3,)).R, jlie.SE3.identity((3,)).R)


def test_sim3_class():
    rng = np.random.default_rng(10)
    xi = np.concatenate([rng.standard_normal((16, 3)), rotvecs(1.0, n=16, seed=10),
                         rng.standard_normal((16, 1)) * 0.3], -1).astype(np.float32)
    j, t = both(xi)
    aj, at = jlie.Sim3.exp(j), tlie.Sim3.exp(t)
    pts = rng.standard_normal((16, 3)).astype(np.float32)
    close(at.apply(torch.as_tensor(pts)), aj.apply(jnp.asarray(pts)))
    close(at.compose(at.inverse()).t, aj.compose(aj.inverse()).t)
    close(at.inverse().s, aj.inverse().s)
    close(at.to_se3_scaled().t, aj.to_se3_scaled().t)
    close(at.log(), aj.log(), atol=1e-4)


def _obs(seed, n=256):
    rng = np.random.default_rng(seed)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rotvecs(0.3, n=n, seed=seed))))
    t = rng.standard_normal((n, 3)).astype(np.float32)
    X = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    X[:, 2] += 12.0
    uv = rng.uniform(0, 700, (n, 2)).astype(np.float32)
    return R, t, X, uv


def test_project_residual():
    R, t, X, uv = _obs(11)
    rj, Xj, zj = jreproj.project_residual(*(jnp.asarray(a) for a in (R, t, X, uv)),
                                          FX, FY, CX, CY)
    rt, Xt, zt = treproj.project_residual(*(torch.as_tensor(a) for a in (R, t, X, uv)),
                                          FX, FY, CX, CY)
    # r is the difference of two ~700 px values: one float32 ulp there is 6e-5
    close(rt, rj, atol=1e-4)
    close(Xt, Xj)
    close(zt, zj)


def test_pose_point_jacobians():
    R, t, X, _ = _obs(12)
    Xc = np.einsum("nij,nj->ni", R, X) + t
    Jc_j, Jp_j = jreproj.pose_point_jacobians(jnp.asarray(R), jnp.asarray(Xc), FX, FY)
    Jc_t, Jp_t = treproj.pose_point_jacobians(torch.as_tensor(R), torch.as_tensor(Xc), FX, FY)
    close(Jc_t, Jc_j)
    close(Jp_t, Jp_j)
    close(treproj.proj_jacobian_point(torch.as_tensor(Xc), FX, FY),
          jreproj.proj_jacobian_point(jnp.asarray(Xc), FX, FY))


@pytest.mark.parametrize("delta", [1.0, 2.447651936])
def test_huber(delta):
    chi2 = np.concatenate([[0.0, 1e-14, delta * delta],
                           np.random.default_rng(13).exponential(5.0, 253)]).astype(np.float32)
    j, t = both(chi2)
    close(treproj.huber_weight(t, delta), jreproj.huber_weight(j, delta))
    close(treproj.huber_rho(t, delta), jreproj.huber_rho(j, delta))


def test_level_sigma2_and_threshold():
    octave = np.arange(8, dtype=np.int32)
    close(treproj.level_sigma2(torch.as_tensor(octave)),
          jreproj.level_sigma2(jnp.asarray(octave)))
    assert treproj.CHI2_MONO == jreproj.CHI2_MONO
