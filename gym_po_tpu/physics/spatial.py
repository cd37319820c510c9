"""Quaternion / SO(3) algebra for the JAX rigid-body engine.

All functions are shape-polymorphic over leading batch axes and jit/vmap
friendly.  Quaternions use MuJoCo's ``[w, x, y, z]`` layout so states are
directly comparable with the oracle (reference envs drive MuJoCo whose
``qpos`` stores free-joint orientation this way).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "quat_mul",
    "quat_conj",
    "quat_rotate",
    "quat_rotate_inv",
    "quat_to_mat",
    "axis_angle_quat",
    "quat_integrate",
    "quat_normalize",
]


def quat_mul(q: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product ``q ⊗ p`` ([..., 4] wxyz)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return jnp.stack(
        [
            qw * pw - qx * px - qy * py - qz * pz,
            qw * px + qx * pw + qy * pz - qz * py,
            qw * py - qx * pz + qy * pw + qz * px,
            qw * pz + qx * py - qy * px + qz * pw,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) ``v`` [..., 3] by quaternion(s) ``q`` [..., 4].

    Uses the expanded 15-mul form (no intermediate quaternion products).
    """
    w = q[..., :1]
    u = q[..., 1:]
    t = 2.0 * jnp.cross(u, v)
    return v + w * t + jnp.cross(u, t)


def quat_rotate_inv(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix [..., 3, 3] with ``R @ v_body = v_world``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = jnp.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def axis_angle_quat(axis_times_angle: jnp.ndarray) -> jnp.ndarray:
    """Exponential map: rotation vector [..., 3] → quaternion [..., 4].

    Guarded for the zero-rotation limit (sinc expansion), so it is safe
    under jit and differentiable at 0.
    """
    angle = jnp.linalg.norm(axis_times_angle, axis=-1, keepdims=True)
    half = 0.5 * angle
    # sin(half)/angle with series fallback near 0: 1/2 - angle^2/48
    small = angle < 1e-8
    s = jnp.where(small, 0.5 - angle * angle / 48.0,
                  jnp.sin(half) / jnp.where(small, 1.0, angle))
    return jnp.concatenate([jnp.cos(half), s * axis_times_angle], axis=-1)


def quat_integrate(q: jnp.ndarray, omega_local: jnp.ndarray,
                   dt) -> jnp.ndarray:
    """MuJoCo ``mj_integratePos`` semantics for a free/ball joint: rotate by
    the *local-frame* angular velocity, i.e. ``q ⊗ exp(ω_local·dt)``."""
    return quat_mul(q, axis_angle_quat(omega_local * dt))


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)
