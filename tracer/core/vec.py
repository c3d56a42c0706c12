"""L0 vector math on `[..., 3]` arrays.

The reference models 3-vectors as a CUDA `vec3` struct with overloaded
operators (include/vec3.h). The array shape convention is simply a
trailing axis of size 3 on `jnp` arrays, so every op here is batched and
fusable by XLA; there is no vec3 class.

All functions are pure and differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

NEAR_ZERO_EPS = 1e-8  # reference: include/vec3.h:59


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Inner product over the trailing xyz axis. reference: include/vec3.h:99"""
    return jnp.sum(a * b, axis=-1)


def length_squared(v: jnp.ndarray) -> jnp.ndarray:
    """reference: include/vec3.h:54 (len_squared)"""
    return jnp.sum(v * v, axis=-1)


@jax.custom_jvp
def sqrt_grad_safe(x):
    """sqrt with a bounded derivative at 0.

    Forward is bit-identical to jnp.sqrt. The true derivative diverges at
    x = 0, and the masked-branch pattern `where(mask, a, f(sqrt(x)))`
    multiplies a REAL zero cotangent into that infinity — 0 * inf = NaN —
    whenever any lane's x lands exactly on 0. refract hits 0 exactly for
    every grazing ray once ir = 1 (i.e. on ALL non-dielectric materials,
    whose masked-out dielectric branch still gets differentiated), which
    silently poisoned every geometry gradient at high ray counts.
    """
    return jnp.sqrt(x)


@sqrt_grad_safe.defjvp
def _sqrt_grad_safe_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = jnp.sqrt(x)
    return y, dx / (2.0 * jnp.maximum(y, 1e-12))


def length(v: jnp.ndarray) -> jnp.ndarray:
    """reference: include/vec3.h:55 (len); gradient bounded at |v| = 0
    (dead/masked lanes would otherwise poison gradients via 0 * inf)."""
    return sqrt_grad_safe(length_squared(v))


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over the trailing axis. reference: include/vec3.h:101-103"""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def unit_vector(v: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Normalize over the trailing axis. reference: include/vec3.h:105.

    `eps` guards the norm for lanes carrying dead/degenerate rays (masked
    wavefront lanes must not produce NaNs that poison gradients).
    """
    n2 = length_squared(v)
    if eps:
        n2 = jnp.maximum(n2, eps)
    return v * jax.lax.rsqrt(n2)[..., None]


def near_zero(v: jnp.ndarray) -> jnp.ndarray:
    """All components below 1e-8. reference: include/vec3.h:58-61"""
    return jnp.all(jnp.abs(v) < NEAR_ZERO_EPS, axis=-1)


def reflect(v: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror `v` about the plane with unit normal `n`. reference: include/vec3.h:63"""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv: jnp.ndarray, n: jnp.ndarray, etai_over_etat: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of unit vector `uv` about unit normal `n`.

    reference: include/vec3.h:65-70. `etai_over_etat` broadcasts over the
    batch (shape `[...]` or scalar).
    """
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    eta = jnp.asarray(etai_over_etat)[..., None]
    r_out_perp = eta * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -sqrt_grad_safe(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel
