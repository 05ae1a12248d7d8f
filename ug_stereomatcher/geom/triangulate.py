"""Least-squares two-view triangulation, vectorised.

Solves the reference's 4-equation intersection (get3DPoint,
getPointCloud.cpp:886-949): P1 is assumed axis-aligned (only rows 0/1 of
its left 3x3 used, zero skew), while P2 is the *full* 3x4 projection of the
verged right camera.  The reference expands the least-squares solution
symbolically and evaluates it per pixel in double precision in a scalar
C++ loop.  Here the same least-squares problem is solved per pixel by a
modified Gram-Schmidt QR of its 4x3 system, as one fused elementwise XLA
computation in float32: the expanded form's determinant is a difference of
terms ~1e6 times larger than itself for nearly parallel rays, which float32
cannot carry (0.6% median depth error on a 16MP verged rig), while the QR
solve loses only ~cond(A) * eps.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def _system(P1, P2, x1, y1, x2, y2):
    """Columns of the per-pixel 4x3 system A and its right-hand side r
    (getPointCloud.cpp:917-928): A @ (X, Y, Z) = r."""
    a = P1[0, 0]
    b = P1[0, 2] - x1
    c = P1[1, 1]
    d = P1[1, 2] - y1
    e = P2[0, 0] - x2 * P2[2, 0]
    f = P2[0, 1] - x2 * P2[2, 1]
    g = P2[0, 2] - x2 * P2[2, 2]
    h = P2[1, 0] - y2 * P2[2, 0]
    i = P2[1, 1] - y2 * P2[2, 1]
    j = P2[1, 2] - y2 * P2[2, 2]
    x = x2 * P2[2, 3] - P2[0, 3]
    y = y2 * P2[2, 3] - P2[1, 3]
    zero = jnp.zeros_like(b)
    cols = ([a + zero, zero, e, h], [zero, c + zero, f, i], [b, d, g, j])
    return cols, [zero, zero, x, y]


def _dot(u, v):
    return sum(p * q for p, q in zip(u, v))


def _axpy(alpha, u, v):
    """v - alpha * u, elementwise over the 4 rows."""
    return [q - alpha * p for p, q in zip(u, v)]


def triangulate_points(P1, P2, x1, y1, x2, y2) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Triangulate matched pixel fields (x1,y1) <-> (x2,y2).

    P1, P2: (3,4) projection matrices.  x1..y2: broadcastable float arrays.
    Returns (X, Y, Z) in the left-camera frame — the least-squares
    solution the reference writes in closed form (getPointCloud.cpp:930-947).
    """
    P1 = jnp.asarray(P1)
    P2 = jnp.asarray(P2)
    (c1, c2, c3), r = _system(P1, P2, x1, y1, x2, y2)
    # modified Gram-Schmidt on [A | r]: A = QR, then R @ X = Q^T r
    r11 = jnp.sqrt(_dot(c1, c1))
    q1 = [v / r11 for v in c1]
    r12, r13, z1 = _dot(q1, c2), _dot(q1, c3), _dot(q1, r)
    c2, c3, r = _axpy(r12, q1, c2), _axpy(r13, q1, c3), _axpy(z1, q1, r)
    r22 = jnp.sqrt(_dot(c2, c2))
    q2 = [v / r22 for v in c2]
    r23, z2 = _dot(q2, c3), _dot(q2, r)
    c3, r = _axpy(r23, q2, c3), _axpy(z2, q2, r)
    r33 = jnp.sqrt(_dot(c3, c3))
    z3 = _dot(c3, r) / r33
    Z = z3 / r33
    Y = (z2 - r23 * Z) / r22
    X = (z1 - r12 * Y - r13 * Z) / r11
    return X, Y, Z


def triangulate_disparity(P1, P2, disp_h: jnp.ndarray, disp_v: jnp.ndarray
                          ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Triangulate a full-resolution two-axis disparity map.

    Pixel (xx, yy) in the left image matches (xx + disp_h, yy + disp_v) in
    the right image (getPointCloud.cpp:909-914)."""
    h, w = disp_h.shape
    dt = disp_h.dtype
    xx = jnp.broadcast_to(jnp.arange(w, dtype=dt)[None, :], (h, w))
    yy = jnp.broadcast_to(jnp.arange(h, dtype=dt)[:, None], (h, w))
    return triangulate_points(P1, P2, xx, yy, xx + disp_h, yy + disp_v)


def range_map(P1, P2, disp_h: jnp.ndarray, disp_v: jnp.ndarray) -> jnp.ndarray:
    """Z-only triangulation (getRangePoint, getPointCloud.cpp:951-982)."""
    _, _, z = triangulate_disparity(P1, P2, disp_h, disp_v)
    return z
