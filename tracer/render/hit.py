"""Nearest-hit scene intersection for ray batches.

Batched form of reference `hit_scene` (include/scene.h:23-54): instead
of a sequential closest-so-far loop (or per-ray BVH stack), compute the
valid-hit parameter for every (ray, primitive) pair as a dense `[R, S+P]`
matrix and take the argmin over primitives. For the reference's ~200
primitive scenes this is dense elementwise work with no divergence; large scenes
switch to the BVH path (tracer/bvh).

The winner's HitRecord is recomputed from the gathered primitive data, so
the O(R x N) phase touches only the scalar t matrix.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from tracer.geometry import plane as plane_mod
from tracer.geometry import sphere as sphere_mod
from tracer.scene.types import K_INFINITY, Scene

T_MIN = 1e-3  # reference camera.cu:226 Interval(0.001f, 1e30f)
T_MAX = 1e30


class HitRecord(NamedTuple):
    """SoA of reference HitRecord (include/hittable_object.h:8-21)."""

    hit: jnp.ndarray  # [R] bool
    t: jnp.ndarray  # [R] f32
    point: jnp.ndarray  # [R, 3] f32
    normal: jnp.ndarray  # [R, 3] f32 (face-oriented)
    front_face: jnp.ndarray  # [R] bool
    material_idx: jnp.ndarray  # [R] i32
    u: jnp.ndarray  # [R] f32
    v: jnp.ndarray  # [R] f32


def hit_scene_brute(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX) -> HitRecord:
    """Nearest hit over all spheres and planes. origin/direction: [R, 3]."""
    num_s = scene.num_spheres
    num_p = scene.num_planes
    r = origin.shape[0]

    ts = []
    if num_s:
        ts.append(
            sphere_mod.sphere_ts(
                origin, direction, scene.spheres.center, scene.spheres.radius, t_min, t_max
            )
        )
    if num_p:
        ts.append(plane_mod.plane_ts(origin, direction, scene.planes, t_min, t_max))
    if not ts:
        zeros = jnp.zeros((r,), jnp.float32)
        return HitRecord(
            hit=jnp.zeros((r,), bool),
            t=jnp.full((r,), K_INFINITY, jnp.float32),
            point=jnp.zeros((r, 3), jnp.float32),
            normal=jnp.zeros((r, 3), jnp.float32),
            front_face=jnp.zeros((r,), bool),
            material_idx=jnp.zeros((r,), jnp.int32),
            u=zeros,
            v=zeros,
        )

    t_all = jnp.concatenate(ts, axis=1)  # [R, S+P]
    winner = jnp.argmin(t_all, axis=1)  # [R]
    t_best = jnp.take_along_axis(t_all, winner[:, None], axis=1)[:, 0]
    hit = t_best < K_INFINITY

    if num_s and num_p:
        is_sphere = winner < num_s
        s_idx = jnp.where(is_sphere, winner, 0)
        p_idx = jnp.where(is_sphere, 0, winner - num_s)
    elif num_s:
        is_sphere = jnp.ones((r,), bool)
        s_idx = winner
        p_idx = jnp.zeros((r,), jnp.int32)
    else:
        is_sphere = jnp.zeros((r,), bool)
        s_idx = jnp.zeros((r,), jnp.int32)
        p_idx = winner

    return _winner_record(scene, origin, direction, t_best, hit, is_sphere, s_idx, p_idx)


def _winner_record(scene: Scene, origin, direction, t_best, hit, is_sphere, s_idx, p_idx) -> HitRecord:
    """Recompute the HitRecord for each ray's winning primitive.

    Miss lanes carry t = +inf; computing records from it would produce
    ~1e32 points/normals whose *backward* paths poison gradients with
    0 * inf = NaN even though the forward is masked out. Records for
    miss lanes are therefore computed at a sanitized t (their values are
    garbage either way and fully masked downstream).
    """
    r = origin.shape[0]
    t_calc = jnp.where(hit, t_best, 1.0)
    zero3 = jnp.zeros((r, 3), jnp.float32)
    zero = jnp.zeros((r,), jnp.float32)
    false = jnp.zeros((r,), bool)
    izero = jnp.zeros((r,), jnp.int32)

    if scene.num_spheres:
        sp = scene.spheres
        s_point, s_normal, s_front, s_u, s_v = sphere_mod.sphere_record(
            origin, direction, t_calc, sp.center[s_idx], sp.radius[s_idx]
        )
        s_mat = sp.material_idx[s_idx]
    else:
        s_point, s_normal, s_front, s_u, s_v, s_mat = zero3, zero3, false, zero, zero, izero

    if scene.num_planes:
        pl = scene.planes
        p_point, p_normal, p_front, p_u, p_v = plane_mod.plane_record(
            origin,
            direction,
            t_calc,
            pl.base[p_idx],
            pl.u[p_idx],
            pl.v[p_idx],
            pl.normal[p_idx],
            pl.d[p_idx],
            pl.w[p_idx],
        )
        p_mat = pl.material_idx[p_idx]
    else:
        p_point, p_normal, p_front, p_u, p_v, p_mat = zero3, zero3, false, zero, zero, izero

    sphere_sel = is_sphere[:, None]
    return HitRecord(
        hit=hit,
        t=t_best,
        point=jnp.where(sphere_sel, s_point, p_point),
        normal=jnp.where(sphere_sel, s_normal, p_normal),
        front_face=jnp.where(is_sphere, s_front, p_front),
        material_idx=jnp.where(is_sphere, s_mat, p_mat),
        u=jnp.where(is_sphere, s_u, p_u),
        v=jnp.where(is_sphere, s_v, p_v),
    )
