"""SO(3)/SE(3)/Sim(3) operations on batched torch tensors (frozen copy of
spslam_tpu_torch/geometry/lie.py).

Conventions as in the reference: quaternions ``[w, x, y, z]`` (Hamilton),
SE(3) as 7-vectors ``[qw qx qy qz tx ty tz]`` mapping ``x -> R x + t``,
Sim(3) as 8-vectors ``[qw qx qy qz tx ty tz s]`` mapping ``x -> s R x + t``,
tangents ``[rho(3), phi(3)]`` and ``[rho(3), phi(3), sigma]``.  Every
function broadcasts over leading dims.  RGB-D fixes the scale, so the
loop path itself needs no Sim(3); the group is here for the reference's
public surface.  The identity constructors take a device (None is the
card, as for every entry point).

Forward-mode autodiff (`torch.func.jacfwd`) goes through `so3_log` and
`se3_log` at exactly zero rotation: the pose graph linearizes its
structural edges at zero residual.  There the norm of the quaternion's
vector part has no derivative, so `so3_log` feeds its unused branch a safe
value (the double-`where` form): no NaN enters either branch's tangent, as
none leaks out of `jnp.where` in the reference.
"""

from __future__ import annotations

import torch



def resolve_device(device=None) -> torch.device:
    """None means the CPU here: the reference is handed its device."""
    return torch.device("cpu" if device is None else device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_identity(device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                        device=resolve_device(device))


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp_min(torch.linalg.norm(q, dim=-1, keepdim=True), 1e-12)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    # the sign flip by concatenation: a constant tensor made from a list
    # would be a blocking host->device copy at every call on CUDA
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v' = v + w t + qv x t with t = 2 qv x v."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> quaternion, branch-free 4-candidate construction."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    idx = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, 1e-12))

    sw = safe_sqrt(qw2) * 2.0
    qa = torch.stack([sw / 4.0, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1)
    sx = safe_sqrt(qx2) * 2.0
    qb = torch.stack([(m21 - m12) / sx, sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1)
    sy = safe_sqrt(qy2) * 2.0
    qc = torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy], dim=-1)
    sz = safe_sqrt(qz2) * 2.0
    qd = torch.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0], dim=-1)
    all_q = torch.stack([qa, qb, qc, qd], dim=-2)                  # [..., 4, 4]
    q = torch.take_along_dim(all_q, idx[..., None, None], dim=-2)[..., 0, :]
    q = torch.where(q[..., 0:1] < 0, -q, q)
    return quat_normalize(q)


def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> quaternion with the small-angle Taylor guard."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return quat_normalize(torch.cat([w, k * phi], dim=-1))


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> axis-angle vector [..., 3]."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:4]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = n2 < 1e-18                      # the reference's norm(v) < 1e-9
    n = torch.sqrt(torch.where(small, 1.0, n2))
    theta = 2.0 * torch.atan2(n, w)
    k = torch.where(small, 2.0 / torch.clamp_min(w, 1e-12), theta / torch.clamp_min(n, 1e-12))
    return k * v


def hat(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def se3_identity(device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=torch.float32,
                        device=resolve_device(device))


def se3_q(T: torch.Tensor) -> torch.Tensor:
    return T[..., 0:4]


def se3_t(T: torch.Tensor) -> torch.Tensor:
    return T[..., 4:7]


def se3_make(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_normalize(q), t], dim=-1)


def se3_apply(T: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return quat_rotate(se3_q(T), x) + se3_t(T)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A*B)(x) = A(B(x))."""
    q = quat_mul(se3_q(A), se3_q(B))
    t = quat_rotate(se3_q(A), se3_t(B)) + se3_t(A)
    return se3_make(q, t)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(se3_q(T))
    ti = -quat_rotate(qi, se3_t(T))
    return se3_make(qi, ti)


def se3_matrix(T: torch.Tensor) -> torch.Tensor:
    """7-vector -> 4x4 homogeneous matrix (batched)."""
    top = torch.cat([quat_to_mat(se3_q(T)), se3_t(T)[..., None]], dim=-1)
    # [0 0 0 1] by padding: a constant made from a list would be a
    # blocking host->device copy on CUDA
    one = torch.ones(T.shape[:-1] + (1, 1), dtype=T.dtype, device=T.device)
    return torch.cat([top, torch.nn.functional.pad(one, (3, 0))], dim=-2)


def se3_from_matrix(M: torch.Tensor) -> torch.Tensor:
    return se3_make(mat_to_quat(M[..., :3, :3]), M[..., :3, 3])


def _V_matrix(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3), batched."""
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-24))
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    small = theta2 < 1e-12
    A = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp_min(theta2, 1e-24))
    B = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp_min(theta2 * theta, 1e-24),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(Phi.shape)
    return eye + A * Phi + B * Phi2


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    q = so3_exp_quat(phi)
    t = (_V_matrix(phi) @ rho[..., None])[..., 0]
    return se3_make(q, t)


def se3_retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction exp(xi) * T (the g2o SE3 update)."""
    return se3_compose(se3_exp(xi), T)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = A^{-1} b for batched 3x3 A by the adjugate: elementwise only, so
    it runs under vmap/jacfwd and never syncs (the reference solves by LU)."""
    a, bb, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - bb * i, bb * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, bb * g - a * h, a * e - bb * d], -1),
    ], -2)
    det = a * adj[..., 0, 0] + bb * adj[..., 1, 0] + c * adj[..., 2, 0]
    return (adj @ b[..., None])[..., 0] / det[..., None]


def se3_log(T: torch.Tensor) -> torch.Tensor:
    phi = so3_log(se3_q(T))
    rho = _solve3(_V_matrix(phi), se3_t(T))
    return torch.cat([rho, phi], dim=-1)


# ---------------------------------------------------------------------------
# Sim(3) as 8-vectors [qw qx qy qz tx ty tz s]
# ---------------------------------------------------------------------------


def sim3_identity(device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 1.0], dtype=torch.float32,
                        device=resolve_device(device))


def sim3_make(q: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    """s: a number, a tensor of q's leading shape, or one with a trailing 1."""
    if not isinstance(s, torch.Tensor):
        s = torch.full(q.shape[:-1] + (1,), float(s), dtype=q.dtype, device=q.device)
    s = s.to(q.dtype)
    if s.dim() < q.dim():
        s = s[..., None].expand(q.shape[:-1] + (1,))
    elif s.shape[-1] != 1:
        s = s[..., None]
    return torch.cat([quat_normalize(q), t, s], dim=-1)


def sim3_q(S: torch.Tensor) -> torch.Tensor:
    return S[..., 0:4]


def sim3_t(S: torch.Tensor) -> torch.Tensor:
    return S[..., 4:7]


def sim3_s(S: torch.Tensor) -> torch.Tensor:
    return S[..., 7]


def sim3_apply(S: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return sim3_s(S)[..., None] * quat_rotate(sim3_q(S), x) + sim3_t(S)


def sim3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    q = quat_mul(sim3_q(A), sim3_q(B))
    s = sim3_s(A) * sim3_s(B)
    t = sim3_s(A)[..., None] * quat_rotate(sim3_q(A), sim3_t(B)) + sim3_t(A)
    return sim3_make(q, t, s)


def sim3_inverse(S: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(sim3_q(S))
    si = 1.0 / torch.clamp_min(sim3_s(S), 1e-12)
    ti = -si[..., None] * quat_rotate(qi, sim3_t(S))
    return sim3_make(qi, ti, si)


def sim3_from_se3(T: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(T.shape[:-1] + (1,), dtype=T.dtype, device=T.device)
    return torch.cat([T, ones], dim=-1)


def se3_from_sim3(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> SE(3) with the translation divided by the scale (the
    loop-correction convention [R t/s; 0 1])."""
    t = sim3_t(S) / torch.clamp_min(sim3_s(S)[..., None], 1e-12)
    return se3_make(sim3_q(S), t)


def sim3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent [rho, phi, sigma] -> Sim(3): W = C I + A Phi + B Phi^2
    (Strasdat's closed form), with the reference's four coefficient
    branches (general, small sigma, small theta, both) over safe
    denominators, so no branch divides by zero."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    q = so3_exp_quat(phi)

    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp_min(theta2, 1e-24))
    Phi = hat(phi)
    Phi2 = Phi @ Phi
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(Phi.shape)

    sig_small = torch.abs(sigma) < 1e-6
    th_small = theta2 < 1e-12
    safe_sig = torch.where(sig_small, 1.0, sigma)
    safe_th = torch.where(th_small, 1.0, theta)
    safe_th2 = torch.where(th_small, 1.0, theta2)

    C = torch.where(sig_small, 1.0, (s - 1.0) / safe_sig)
    a = s * torch.sin(safe_th)
    b = s * torch.cos(safe_th)
    den = safe_sig * safe_sig + safe_th2
    A_gen = (a * safe_sig + (1.0 - b) * safe_th) / (safe_th * den)
    B_gen = (C - ((b - 1.0) * safe_sig + a * safe_th) / den) / safe_th2
    A_thsmall = torch.where(sig_small, 0.5, ((safe_sig - 1.0) * s + 1.0) / (safe_sig * safe_sig))
    B_thsmall = torch.where(
        sig_small, 1.0 / 6.0,
        (s * (0.5 * safe_sig * safe_sig - safe_sig + 1.0) - 1.0) / (safe_sig ** 3),
    )
    A_sigsmall = (1.0 - torch.cos(safe_th)) / safe_th2
    B_sigsmall = (safe_th - torch.sin(safe_th)) / (safe_th2 * safe_th)
    A = torch.where(th_small, A_thsmall, torch.where(sig_small, A_sigsmall, A_gen))
    B = torch.where(th_small, B_thsmall, torch.where(sig_small, B_sigsmall, B_gen))

    W = C[..., None, None] * eye + A[..., None, None] * Phi + B[..., None, None] * Phi2
    t = (W @ rho[..., None])[..., 0]
    return sim3_make(q, t, s)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> tangent [rho, phi, sigma]: W is rebuilt column by column
    from sim3_exp of the unit rho's, then W rho = t is solved (adjugate,
    no host sync)."""
    phi = so3_log(sim3_q(S))
    sigma = torch.log(torch.clamp_min(sim3_s(S), 1e-12))[..., None]
    e = torch.eye(3, dtype=S.dtype, device=S.device)
    W = torch.stack([
        sim3_t(sim3_exp(torch.cat([e[i].expand(phi.shape), phi, sigma], dim=-1)))
        for i in range(3)
    ], dim=-1)
    rho = _solve3(W, sim3_t(S))
    return torch.cat([rho, phi, sigma], dim=-1)
