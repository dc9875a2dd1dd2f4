"""Batched SO(3) / SE(3) / Sim(3) Lie-group operations (PyTorch).

Counterpart of ``ccm_slam_tpu/utils/lie.py``: the same functions, the same
conventions and the same Taylor guards and thresholds, on torch tensors.

Conventions:
* Rotations are 3x3 matrices; quaternions are (w, x, y, z), Hamilton.
* SE(3) tangent is ``[rho(3), phi(3)]`` (translation first, like g2o).
* Sim(3) tangent is ``[rho(3), phi(3), sigma(1)]``; ``exp`` gives
  ``(s, R, t) = (e^sigma, exp(phi), W(phi, sigma) rho)`` where W is the
  closed-form integral  W = C I + (alpha/theta) K + ((C - beta)/theta^2) K^2
  with C = (s-1)/sigma,  alpha = int_0^1 e^{su} sin(u theta) du,
  beta = int_0^1 e^{su} cos(u theta) du  (Taylor-guarded for small angles).

A Sim(3) with s=1 is an SE(3); helpers accept either.  All functions
broadcast over arbitrary leading batch dimensions.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(v):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(m):
    """[..., 3, 3] skew matrix -> [..., 3]."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def orthonormalize(R):
    """Project [..., 3, 3] matrices back onto SO(3) (nearest rotation).

    Two Newton-polar iterations ``R <- R (3I - R^T R) / 2``: each maps a
    singular-value defect e to ~1.5 e^2, so near-orthogonal inputs (defect
    <= ~0.1) land at float-precision orthogonality.  Apply after every chain
    of multiplicative rotation updates (``dR @ R`` in the solvers): float32
    defects otherwise grow geometrically through iterated products."""
    eye3 = 3.0 * _eye3(R)
    for _ in range(2):
        R = 0.5 * (R @ (eye3 - R.transpose(-1, -2) @ R))
    return R


def so3_exp(phi):
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)  # safe; exact at 0 via Taylor branch
    small = theta2 < 1e-8
    k = hat(phi)
    k2 = k @ k
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16)
    )
    eye = _eye3(phi).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * k2


def so3_log(R):
    """[..., 3, 3] -> [..., 3].  Handles angles up to pi (pi-neighborhood via
    the diagonal-dominant axis extraction)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) * 0.5  # = sin(theta) * axis
    # sin from the skew part (well-conditioned near pi, unlike sqrt(1-cos^2));
    # sqrt(sum(w * w)), as jnp.linalg.norm computes it: its derivative at an
    # exactly symmetric R is NaN in both packages (ROADMAP section 3), where
    # torch.linalg.vector_norm's would be 0
    sin_theta = torch.sqrt(torch.sum(w * w, dim=-1))
    theta = torch.atan2(sin_theta, cos_theta)

    # Generic branch: phi = theta / sin(theta) * w  (theta/sin -> 1 at 0)
    small = sin_theta < 1e-6
    scale = torch.where(
        small, 1.0 + theta * theta / 6.0, theta / sin_theta.clamp(min=1e-12)
    )
    phi_generic = scale[..., None] * w

    # Near pi: axis from the largest column of (R + R^T)/2 - cos I = (1-cos) a a^T
    B = (R + R.transpose(-1, -2)) * 0.5 - cos_theta[..., None, None] * _eye3(R)
    col_norms = torch.linalg.vector_norm(B, dim=-2)
    j = torch.argmax(col_norms, dim=-1)
    idx = j[..., None, None].expand(*B.shape[:-1], 1)
    axis_raw = torch.gather(B, -1, idx)[..., 0]
    axis = axis_raw / torch.linalg.vector_norm(axis_raw, dim=-1, keepdim=True).clamp(
        min=1e-12
    )
    # fix the sign so that it agrees with the skew part
    sign = torch.where(torch.sum(axis * w, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    phi_pi = theta[..., None] * axis * sign

    # The generic branch's relative error blows up as sin(theta) -> 0 with
    # cos(theta) < 0, so switch to the diagonal-based axis well before sin
    # underflows.
    near_pi = (sin_theta < 1e-3) & (cos_theta < 0.0)
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def _se3_V_coeffs(theta2):
    """Coefficients (b, c) of V = I + b K + c K^2 for SE(3) exp."""
    theta = torch.sqrt(theta2.clamp(min=1e-16))
    small = theta2 < 1e-8
    b = torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2.clamp(min=1e-16)
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta).clamp(min=1e-16),
    )
    return b, c


def _se3_V(phi):
    theta2 = torch.sum(phi * phi, dim=-1)
    k = hat(phi)
    k2 = k @ k
    b, c = _se3_V_coeffs(theta2)
    eye = _eye3(phi).expand(k.shape)
    return eye + b[..., None, None] * k + c[..., None, None] * k2


def se3_exp(xi):
    """[..., 6] (rho, phi) -> (R [...,3,3], t [...,3])."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    R = so3_exp(phi)
    t = (_se3_V(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R, t):
    """(R, t) -> [..., 6]."""
    phi = so3_log(R)
    rho = torch.linalg.solve(_se3_V(phi), t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def _sim3_W(phi, sigma):
    """W(phi, sigma): [...,3] x [...] -> [...,3,3] such that t = W rho."""
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(theta2.clamp(min=1e-16))
    s = torch.exp(sigma)
    k = hat(phi)
    k2 = k @ k
    sig_small = torch.abs(sigma) < 1e-5
    th_small = theta2 < 1e-8
    sig_safe = torch.where(sig_small, 1.0, sigma)
    th_safe = torch.where(th_small, 1.0, theta)
    denom = sigma * sigma + theta2
    denom_safe = torch.where(denom < 1e-12, 1.0, denom)

    # C = (s - 1)/sigma  (-> 1 + sigma/2 as sigma -> 0)
    C = torch.where(
        sig_small, 1.0 + sigma / 2.0 + sigma * sigma / 6.0, (s - 1.0) / sig_safe
    )

    # alpha = int e^{sigma u} sin(u theta) du; A = alpha/theta
    alpha = (s * (sigma * torch.sin(theta) - theta * torch.cos(theta)) + theta) / denom_safe
    A_generic = alpha / th_safe
    # theta->0: A -> int u e^{sigma u} du = (s(sigma-1)+1)/sigma^2 -> 1/2 + sigma/3
    A_th0 = torch.where(
        sig_small,
        0.5 + sigma / 3.0 + sigma * sigma / 8.0,
        (s * (sigma - 1.0) + 1.0) / (sig_safe * sig_safe),
    )
    A = torch.where(th_small, A_th0, A_generic)

    # beta = int e^{sigma u} cos(u theta) du; B = (C - beta)/theta^2
    beta = (s * (sigma * torch.cos(theta) + theta * torch.sin(theta)) - sigma) / denom_safe
    B_generic = (C - beta) / torch.where(th_small, 1.0, theta2)
    # theta->0: B -> 1/2 int u^2 e^{sigma u} du = (s(sigma^2-2sigma+2)-2)/(2 sigma^3)
    B_th0 = torch.where(
        sig_small,
        1.0 / 6.0 + sigma / 8.0 + sigma * sigma / 20.0,
        (s * (sigma * sigma - 2.0 * sigma + 2.0) - 2.0) / (2.0 * sig_safe**3),
    )
    B = torch.where(th_small, B_th0, B_generic)

    eye = _eye3(phi).expand(k.shape)
    return C[..., None, None] * eye + A[..., None, None] * k + B[..., None, None] * k2


def sim3_exp(xi):
    """[..., 7] (rho, phi, sigma) -> (s [...], R [...,3,3], t [...,3])."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = so3_exp(phi)
    s = torch.exp(sigma)
    t = (_sim3_W(phi, sigma) @ rho[..., None])[..., 0]
    return s, R, t


def sim3_log(s, R, t):
    """(s, R, t) -> [..., 7]."""
    sigma = torch.log(s)
    phi = so3_log(R)
    rho = torch.linalg.solve(_sim3_W(phi, sigma), t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_to_rot(q):
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Shepperd's method, branch-free via where-select of 4 candidates."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate formulations; pick the numerically best one.
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0), (m10 - m01) / (4 * qw0)],
        dim=-1,
    )
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1)],
        dim=-1,
    )
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2)],
        dim=-1,
    )
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3],
        dim=-1,
    )

    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(*cands.shape[:-2], 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # canonical sign: w >= 0
    return torch.where(q[..., :1] < 0, -q, q)


# ---------------------------------------------------------------------------
# Transform dataclasses (batched over leading dims)
# ---------------------------------------------------------------------------


def _broadcast_apply(R, t, x):
    """Apply [batch..., 3,3] rotation + translation to points
    [batch..., extra..., 3]: extra point axes beyond the transform's batch are
    broadcast (e.g. a [H] batch of transforms on [H, N, 3] or [N, 3] points)."""
    extra = (x.ndim - 1) - (R.ndim - 2)
    if extra < 0:
        # transform batch broadcasts over plain points instead
        return (R @ x[..., None])[..., 0] + t
    Rb = R.reshape(R.shape[:-2] + (1,) * extra + (3, 3))
    tb = t.reshape(t.shape[:-1] + (1,) * extra + (3,))
    return (Rb @ x[..., None])[..., 0] + tb


@dataclass
class SE3:
    """Rigid transform x' = R x + t.  Fields broadcast over leading dims."""

    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None):
        R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
        t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
        return cls(R=R, t=t)

    @classmethod
    def exp(cls, xi):
        R, t = se3_exp(xi)
        return cls(R=R, t=t)

    def log(self):
        return se3_log(self.R, self.t)

    def apply(self, x):
        return _broadcast_apply(self.R, self.t, x)

    def compose(self, other: "SE3") -> "SE3":
        return SE3(R=self.R @ other.R, t=(self.R @ other.t[..., None])[..., 0] + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(R=Rt, t=-(Rt @ self.t[..., None])[..., 0])

    def matrix(self):
        bottom = torch.tensor(
            [0.0, 0.0, 0.0, 1.0], dtype=self.t.dtype, device=self.t.device
        ).expand(*self.t.shape[:-1], 1, 4)
        top = torch.cat([self.R, self.t[..., None]], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    @classmethod
    def from_matrix(cls, T):
        return cls(R=T[..., :3, :3], t=T[..., :3, 3])

    def to_sim3(self) -> "Sim3":
        return Sim3(s=torch.ones_like(self.t[..., 0]), R=self.R, t=self.t)


@dataclass
class Sim3:
    """Similarity transform x' = s R x + t."""

    s: torch.Tensor  # [...]
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32, device=None):
        return cls(
            s=torch.ones(batch_shape, dtype=dtype, device=device),
            R=torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3),
            t=torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        )

    @classmethod
    def exp(cls, xi):
        s, R, t = sim3_exp(xi)
        return cls(s=s, R=R, t=t)

    def log(self):
        return sim3_log(self.s, self.R, self.t)

    def apply(self, x):
        sR = self.s[..., None, None] * self.R
        return _broadcast_apply(sR, self.t, x)

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(
            s=self.s * other.s,
            R=self.R @ other.R,
            t=self.s[..., None] * (self.R @ other.t[..., None])[..., 0] + self.t,
        )

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(s=s_inv, R=Rt, t=-s_inv[..., None] * (Rt @ self.t[..., None])[..., 0])

    def __getitem__(self, idx) -> "Sim3":
        """The transforms at ``idx`` of the batch axis."""
        return Sim3(s=self.s[idx], R=self.R[idx], t=self.t[idx])

    def to_se3_scaled(self) -> SE3:
        """[R, t/s] conversion used when projecting a Sim3 back to a rigid
        pose."""
        return SE3(R=self.R, t=self.t / self.s[..., None])


def se3_relative(T_a: SE3, T_b: SE3) -> SE3:
    """T_ab = T_a * T_b^{-1}: pose of b's frame expressed in a's."""
    return T_a.compose(T_b.inverse())
