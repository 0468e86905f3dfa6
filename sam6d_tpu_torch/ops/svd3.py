"""Closed-form batched 3x3 SVD by cyclic Jacobi, structure of arrays.

Counterpart of `sam6d_tpu/ops/svd3.py`: the same fixed sweep schedule,
rotation formulas, descending sort, and U completion, so the sign and
order conventions of the pose solvers are the reference's.  Every
quantity is a component tensor of shape (...,); no (..., 3, 3) algebra.
"""

from __future__ import annotations

import torch

_EPS = 1e-12
_JACOBI_SWEEPS = 6


def _rot_coeffs(app, aqq, apq):
    """Jacobi rotation (c, s) zeroing the (p, q) entry."""
    safe = torch.abs(apq) > _EPS
    tau = (aqq - app) / (2.0 * torch.where(safe, apq, torch.ones_like(apq)))
    sign = torch.where(tau >= 0, torch.ones_like(tau), -torch.ones_like(tau))
    t = sign / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(safe, t, torch.zeros_like(t))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def _eigh3x3_soa(a00, a01, a02, a11, a12, a22):
    one = torch.ones_like(a00)
    zero = torch.zeros_like(a00)
    v00, v01, v02 = one, zero, zero
    v10, v11, v12 = zero, one, zero
    v20, v21, v22 = zero, zero, one

    for _ in range(_JACOBI_SWEEPS):
        c, s = _rot_coeffs(a00, a11, a01)
        a00n = c * c * a00 - 2 * s * c * a01 + s * s * a11
        a11n = s * s * a00 + 2 * s * c * a01 + c * c * a11
        a02n = c * a02 - s * a12
        a12n = s * a02 + c * a12
        a00, a11, a01, a02, a12 = a00n, a11n, zero, a02n, a12n
        v00, v01 = c * v00 - s * v01, s * v00 + c * v01
        v10, v11 = c * v10 - s * v11, s * v10 + c * v11
        v20, v21 = c * v20 - s * v21, s * v20 + c * v21

        c, s = _rot_coeffs(a00, a22, a02)
        a00n = c * c * a00 - 2 * s * c * a02 + s * s * a22
        a22n = s * s * a00 + 2 * s * c * a02 + c * c * a22
        a01n = c * a01 - s * a12
        a12n = s * a01 + c * a12
        a00, a22, a02, a01, a12 = a00n, a22n, zero, a01n, a12n
        v00, v02 = c * v00 - s * v02, s * v00 + c * v02
        v10, v12 = c * v10 - s * v12, s * v10 + c * v12
        v20, v22 = c * v20 - s * v22, s * v20 + c * v22

        c, s = _rot_coeffs(a11, a22, a12)
        a11n = c * c * a11 - 2 * s * c * a12 + s * s * a22
        a22n = s * s * a11 + 2 * s * c * a12 + c * c * a22
        a01n = c * a01 - s * a02
        a02n = s * a01 + c * a02
        a11, a22, a12, a01, a02 = a11n, a22n, zero, a01n, a02n
        v01, v02 = c * v01 - s * v02, s * v01 + c * v02
        v11, v12 = c * v11 - s * v12, s * v11 + c * v12
        v21, v22 = c * v21 - s * v22, s * v21 + c * v22

    return (a00, a11, a22), (v00, v01, v02, v10, v11, v12, v20, v21, v22)


def _sort3_desc(w, V):
    """Eigenpairs sorted by descending eigenvalue (compare-swap net)."""
    w0, w1, w2 = w
    v00, v01, v02, v10, v11, v12, v20, v21, v22 = V

    def cswap(wa, wb, cols_a, cols_b):
        swap = wb > wa
        new_a = tuple(torch.where(swap, b, a) for a, b in zip(cols_a, cols_b))
        new_b = tuple(torch.where(swap, a, b) for a, b in zip(cols_a, cols_b))
        return torch.where(swap, wb, wa), torch.where(swap, wa, wb), new_a, new_b

    c0, c1, c2 = (v00, v10, v20), (v01, v11, v21), (v02, v12, v22)
    w0, w1, c0, c1 = cswap(w0, w1, c0, c1)
    w0, w2, c0, c2 = cswap(w0, w2, c0, c2)
    w1, w2, c1, c2 = cswap(w1, w2, c1, c2)
    return (w0, w1, w2), (c0, c1, c2)


def _pack(cols) -> torch.Tensor:
    """Columns (each an (x, y, z) tuple) -> (..., 3, 3) matrix."""
    c0, c1, c2 = cols
    return torch.stack(
        [torch.stack([c0[r], c1[r], c2[r]], dim=-1) for r in range(3)],
        dim=-2,
    )


def _norm3(x, y, z):
    return torch.sqrt(torch.clamp_min(x * x + y * y + z * z, _EPS))


def svd3x3(H: torch.Tensor):
    """H (..., 3, 3) = U diag(s) V^T; s descending, U and V orthonormal."""
    H = H.float()
    h = [[H[..., i, j] for j in range(3)] for i in range(3)]
    (u1, u2, u3), (s1, s2, s3), (v1, v2, v3) = svd3x3_soa(h)
    return _pack((u1, u2, u3)), torch.stack([s1, s2, s3], -1), _pack(
        (v1, v2, v3))


def svd3x3_soa(h):
    """h: 3x3 nested list of component tensors.  Returns
    ((u1, u2, u3), (s1, s2, s3), (v1, v2, v3)), each u_i / v_i an
    (x, y, z) tuple: the i-th column of U / V."""

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    cols = [(h[0][j], h[1][j], h[2][j]) for j in range(3)]
    a00 = dot3(cols[0], cols[0])
    a01 = dot3(cols[0], cols[1])
    a02 = dot3(cols[0], cols[2])
    a11 = dot3(cols[1], cols[1])
    a12 = dot3(cols[1], cols[2])
    a22 = dot3(cols[2], cols[2])

    w, Vc = _eigh3x3_soa(a00, a01, a02, a11, a12, a22)
    w, (v1, v2, v3) = _sort3_desc(w, Vc)

    s1 = torch.sqrt(torch.clamp_min(w[0], 0.0))
    s2 = torch.sqrt(torch.clamp_min(w[1], 0.0))
    s3 = torch.sqrt(torch.clamp_min(w[2], 0.0))
    scale = torch.clamp_min(s1, _EPS)

    def matvec(v):
        return tuple(
            h[r][0] * v[0] + h[r][1] * v[1] + h[r][2] * v[2] for r in range(3)
        )

    def normalize(u):
        n = _norm3(*u)
        return (u[0] / n, u[1] / n, u[2] / n)

    def cross(a, b):
        return (
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        )

    def where3(c, a, b):
        return tuple(torch.where(c, a[i], b[i]) for i in range(3))

    def any_orthonormal(v):
        ax, ay, az = torch.abs(v[0]), torch.abs(v[1]), torch.abs(v[2])
        use_x = (ax <= ay) & (ax <= az)
        use_y = (~use_x) & (ay <= az)
        one, zero = torch.ones_like(ax), torch.zeros_like(ax)
        ex = (torch.where(use_x, one, zero), torch.where(use_y, one, zero),
              torch.where(use_x | use_y, zero, one))
        return normalize(cross(v, ex))

    Hv1, Hv2, Hv3 = matvec(v1), matvec(v2), matvec(v3)

    e1 = (torch.ones_like(s1), torch.zeros_like(s1), torch.zeros_like(s1))
    ok1 = s1 > 1e-6 * scale
    u1 = normalize(where3(
        ok1, tuple(x / torch.clamp_min(s1, _EPS) for x in Hv1), e1))
    ok2 = s2 > 1e-6 * scale
    u2_raw = where3(ok2, tuple(x / torch.clamp_min(s2, _EPS) for x in Hv2),
                    any_orthonormal(u1))
    d12 = dot3(u2_raw, u1)
    u2_o = tuple(u2_raw[i] - d12 * u1[i] for i in range(3))
    n2 = u2_o[0] ** 2 + u2_o[1] ** 2 + u2_o[2] ** 2
    u2 = where3(n2 > 1e-12, normalize(u2_o), any_orthonormal(u1))

    u3_cross = cross(u1, u2)
    ok3 = s3 > 1e-4 * scale
    u3_raw = normalize(tuple(x / torch.clamp_min(s3, _EPS) for x in Hv3))
    u3 = where3(ok3, u3_raw, u3_cross)
    d13 = dot3(u3, u1)
    u3 = tuple(u3[i] - d13 * u1[i] for i in range(3))
    d23 = dot3(u3, u2)
    u3 = tuple(u3[i] - d23 * u2[i] for i in range(3))
    n3 = u3[0] ** 2 + u3[1] ** 2 + u3[2] ** 2
    u3 = where3(n3 > 1e-12, normalize(u3), u3_cross)

    return (u1, u2, u3), (s1, s2, s3), (v1, v2, v3)
