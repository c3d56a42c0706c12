"""Ray-sphere intersection, vectorized over `[R]` rays x `[S]` spheres.

Batched form of reference `hit_sphere` (include/sphere.h:24-53): the
scalar early-return quadratic becomes a branchless `[R, S]` root matrix
with misses encoded as +inf, from which the nearest hit is an argmin.
Differentiable w.r.t. sphere centers and radii through the root formula.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core import vec
from tracer.scene.types import K_INFINITY


def sphere_ts(origin, direction, center, radius, t_min, t_max):
    """Nearest valid root per (ray, sphere).

    Args:
      origin, direction: `[R, 3]` ray origins/directions (dir NOT normalized,
        matching reference ray.h:12 semantics).
      center: `[S, 3]`, radius: `[S]`.
      t_min, t_max: scalar closed interval (reference uses
        Interval.contains, interval.h:16).

    Returns `[R, S]` float32 of the chosen root, +inf where no valid hit.
    Root preference is near-then-far exactly like sphere.h:35-44.
    """
    oc = origin[:, None, :] - center[None, :, :]  # [R, S, 3]
    a = vec.length_squared(direction)[:, None]  # [R, 1]
    half_b = jnp.sum(oc * direction[:, None, :], axis=-1)  # [R, S]
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]  # [R, S]
    disc = half_b * half_b - a * c
    hit = disc >= 0.0
    # sqrt' at the clamp point is inf; miss lanes (disc < 0) would emit
    # 0-cotangent * inf = NaN into d(disc) -> d(center/radius). Sanitize
    # the operand instead of clamping to 0 (miss roots are masked anyway),
    # and bound the derivative at disc == 0 exactly (tangent rays).
    sqrt_d = vec.sqrt_grad_safe(jnp.where(hit, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit & (t_near >= t_min) & (t_near <= t_max)
    far_ok = hit & (t_far >= t_min) & (t_far <= t_max)
    return jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, K_INFINITY))


def sphere_t_gathered(origin, direction, center, radius, t_min, t_max):
    """Nearest valid root for per-ray gathered spheres (one per ray).

    Same semantics as sphere_ts with every sphere field already indexed
    to `[R, ...]` (used by BVH leaf tests). Returns `[R]` t, +inf on miss.
    """
    oc = origin - center
    a = vec.length_squared(direction)
    half_b = jnp.sum(oc * direction, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    disc = half_b * half_b - a * c
    hit = disc >= 0.0
    # sqrt' at the clamp point is inf; miss lanes (disc < 0) would emit
    # 0-cotangent * inf = NaN into d(disc) -> d(center/radius). Sanitize
    # the operand instead of clamping to 0 (miss roots are masked anyway),
    # and bound the derivative at disc == 0 exactly (tangent rays).
    sqrt_d = vec.sqrt_grad_safe(jnp.where(hit, disc, 1.0))
    inv_a = 1.0 / a
    t_near = (-half_b - sqrt_d) * inv_a
    t_far = (-half_b + sqrt_d) * inv_a
    near_ok = hit & (t_near >= t_min) & (t_near <= t_max)
    far_ok = hit & (t_far >= t_min) & (t_far <= t_max)
    return jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, K_INFINITY))


def sphere_uv(outward_normal):
    """Spherical UVs from the unit outward normal.

    reference include/sphere.h:16-22: theta = acos(p.y),
    phi = atan2(-p.z, p.x) + pi; u = phi/2pi, v = theta/pi.
    """
    p = outward_normal
    y = jnp.clip(p[..., 1], -1.0, 1.0)
    # arccos' derivative blows up at |y| = 1 (sphere poles / garbage miss
    # lanes); keep the forward exact but route the gradient through a
    # pole-clamped copy (straight-through).
    y_safe = jnp.clip(y, -1.0 + 1e-6, 1.0 - 1e-6)
    theta = jnp.arccos(y_safe) + jax.lax.stop_gradient(
        jnp.arccos(y) - jnp.arccos(y_safe)
    )
    phi = jnp.arctan2(-p[..., 2], p[..., 0]) + jnp.pi
    return phi / (2.0 * jnp.pi), theta / jnp.pi


def sphere_record(origin, direction, t, center, radius):
    """HitRecord fields for rays whose winning primitive is a sphere.

    reference include/sphere.h:46-51 + hittable_object.h:17-20
    (set_face_normal). All inputs are per-ray (`[R, ...]`, the winning
    sphere's data already gathered).
    """
    point = origin + t[..., None] * direction
    outward = (point - center) / radius[..., None]
    front_face = vec.dot(direction, outward) < 0.0
    normal = jnp.where(front_face[..., None], outward, -outward)
    u, v = sphere_uv(outward)
    return point, normal, front_face, u, v
