"""SO3 / SE3 / Sim3 Lie-group operations in PyTorch.

Conventions as in the reference: the SE3 tangent is [rho(3), phi(3)]
(translation first), the Sim3 tangent [rho(3), phi(3), sigma(1)], and
updates are LEFT-multiplicative, T <- exp(xi) T. Every branch is a
`torch.where` over Taylor fallbacks whose untaken side is finite, so
gradients stay finite at the identity: autograd, like JAX, multiplies the
untaken branch's gradient by zero, and 0·NaN is NaN.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """so3 hat: (…,3) -> (…,3,3) skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W):
    """Inverse of hat: (…,3,3) -> (…,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sinc_terms(theta2):
    """(A, B, C) = sin t/t, (1-cos t)/t², (t - sin t)/t³ with Taylor
    fallbacks near zero; theta2 is t²."""
    theta = torch.sqrt(torch.clamp(theta2, min=1e-14))
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe)) / (safe * safe))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe - torch.sin(safe)) / (safe ** 3))
    return A, B, C


def so3_exp(w):
    """Rodrigues: (…,3) -> (…,3,3)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_terms(theta2)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """(…,3,3) -> (…,3) through the quaternion, stable at 0 and pi:
    w = 2·atan2(|q_v|, q_w)·q_v/|q_v|, small-|q_v| limit 2/q_w·q_v."""
    q = rot_to_quat(R)
    qw = q[..., 0]
    qv = q[..., 1:]
    # both branches stay NaN-free: autograd evaluates the untaken one too
    nv2 = torch.sum(qv * qv, dim=-1)
    safe_nv = torch.sqrt(torch.clamp(nv2, min=1e-14))
    theta = 2.0 * torch.atan2(safe_nv, qw)
    qw_safe = torch.clamp(qw, min=1e-7)
    general = theta / safe_nv
    taylor = 2.0 / qw_safe - 2.0 * nv2 / (3.0 * qw_safe ** 3)
    scale = torch.where(nv2 > 1e-12, general, taylor)
    return scale[..., None] * qv


def so3_left_jacobian(w):
    """V such that exp([rho;phi]) has translation V @ rho."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_terms(theta2)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def so3_left_jacobian_inv(w):
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-14))
    W = hat(w)
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot_term = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe))
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def se3_exp(xi):
    """(…,6) [rho, phi] -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    V = so3_left_jacobian(phi)
    return R, torch.einsum("...ij,...j->...i", V, rho)


def se3_log(R, t):
    phi = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", so3_left_jacobian_inv(phi), t)
    return torch.cat([rho, phi], dim=-1)


def se3_mul(Ra, ta, Rb, tb):
    """(Ra,ta) * (Rb,tb)."""
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, tb) + ta


def se3_inv(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_apply(R, t, p):
    """Transform points p (…,3) by (R,t)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def se3_matrix(R, t):
    """(R,t) -> (…,4,4) homogeneous matrix, in R's dtype and on its
    device."""
    bottom = torch.zeros(R.shape[:-2] + (1, 4), dtype=R.dtype,
                         device=R.device)
    bottom[..., 0, 3] = 1.0
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]


def se3_update_left(R, t, xi):
    """T <- exp(xi) T — the reference's VertexSE3Quat::oplusImpl."""
    dR, dt = se3_exp(xi)
    return se3_mul(dR, dt, R, t)


def quat_to_rot(q):
    """(…,4) wxyz quaternion -> (…,3,3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def rot_to_quat(R):
    """Shepperd's method, branch-free: every case is computed and the most
    stable one is selected. Returns wxyz with q_w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(v):
        return torch.sqrt(torch.clamp(v, min=1e-12)) * 2

    s0 = root(tr + 1.0)
    c0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = root(1.0 + m00 - m11 - m22)
    c1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = root(1.0 + m11 - m00 - m22)
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = root(1.0 + m22 - m00 - m11)
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], -1)
    use0 = tr > 0
    use1 = (m00 >= m11) & (m00 >= m22) & ~use0
    use2 = (m11 > m00) & (m11 >= m22) & ~use0
    q = torch.where(use0[..., None], c0,
                    torch.where(use1[..., None], c1,
                                torch.where(use2[..., None], c2, c3)))
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# Sim3: (R, t, s), used by loop closing. Tangent [rho(3), phi(3), sigma(1)].
# ---------------------------------------------------------------------------

def sim3_apply(R, t, s, p):
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def sim3_mul(Ra, ta, sa, Rb, tb, sb):
    return (Ra @ Rb, sa[..., None] * torch.einsum("...ij,...j->...i", Ra, tb)
            + ta, sa * sb)


def sim3_inv(R, t, s):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return (Rt, -s_inv[..., None] * torch.einsum("...ij,...j->...i", Rt, t),
            s_inv)


def _sim3_V(phi, sigma):
    """V with exp([rho, phi, sigma]) = (exp(phi), V·rho, e^sigma): the
    closed form of g2o's sim3.h, V = A·I + B·W + C·W², its four cases
    (sigma and theta small or not) chosen by `where` over finite
    stand-ins."""
    s = torch.exp(sigma)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-14))
    W = hat(phi)
    W2 = W @ W
    eps = 1e-6
    sigma_small = torch.abs(sigma) < eps
    theta_small = theta < eps
    safe_sigma = torch.where(sigma_small, torch.ones_like(sigma), sigma)
    safe_theta = torch.where(theta_small, torch.ones_like(theta), theta)

    # both small
    A_ss = 1.0 + sigma / 2.0
    B_ss = torch.zeros_like(sigma)
    C_ss = torch.full_like(sigma, 1.0 / 6.0)
    # sigma small, theta not
    A_st = torch.ones_like(sigma)
    B_st = (1.0 - torch.cos(safe_theta)) / torch.clamp(theta2, min=eps)
    C_st = ((safe_theta - torch.sin(safe_theta))
            / torch.clamp(theta2 * safe_theta, min=eps))
    # sigma not small, theta small
    A_ts = (s - 1.0) / safe_sigma
    B_ts = ((s * safe_sigma - s + 1.0)
            / torch.clamp(safe_sigma * safe_sigma, min=eps))
    C_ts = ((s - 1.0) / safe_sigma - (s * safe_sigma - s + 1.0)
            / torch.clamp(safe_sigma * safe_sigma, min=eps)) \
        / torch.clamp(theta2, min=eps)
    C_ts = torch.where(theta_small, torch.zeros_like(C_ts), C_ts)
    # general
    a = s * torch.sin(safe_theta)
    b = s * torch.cos(safe_theta)
    c = theta2 + safe_sigma * safe_sigma
    A_g = (s - 1.0) / safe_sigma
    B_g = ((a * safe_sigma + (1.0 - b) * safe_theta)
           / torch.clamp(safe_theta * c, min=eps))
    C_g = (A_g - ((b - 1.0) * safe_sigma + a * safe_theta)
           / torch.clamp(c, min=eps)) / torch.clamp(theta2, min=eps)

    A = torch.where(sigma_small, torch.where(theta_small, A_ss, A_st),
                    torch.where(theta_small, A_ts, A_g))
    B = torch.where(sigma_small, torch.where(theta_small, B_ss, B_st),
                    torch.where(theta_small, torch.zeros_like(B_ts), B_g))
    C = torch.where(sigma_small, torch.where(theta_small, C_ss, C_st),
                    torch.where(theta_small, C_ts, C_g))
    return (A[..., None, None] * _eye_like(W) + B[..., None, None] * W
            + C[..., None, None] * W2)


def sim3_exp(xi):
    """(…,7) [rho, phi, sigma] -> (R, t, s)."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    V = _sim3_V(phi, sigma)
    return (so3_exp(phi), torch.einsum("...ij,...j->...i", V, rho),
            torch.exp(sigma))


def sim3_log(R, t, s):
    """(R, t, s) -> (…,7): rho solves V·rho = t (solve_ex: no
    singularity check, so no host sync on CUDA)."""
    phi = so3_log(R)
    sigma = torch.log(s)
    V = _sim3_V(phi, sigma)
    rho = torch.linalg.solve_ex(V, t[..., None]).result[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)
