"""Matmul-formulated brute-force intersection (the default intersector).

Mathematically identical to tracer.render.hit.hit_scene_brute, but
restructured as dense array work (SURVEY.md §7 stage 5 groundwork):

- All (ray x primitive) 3-vector contractions become TWO matmuls:
  project o and d once against a stacked [3, S+3P] matrix of sphere
  centers, plane normals and the two precomputed triple-product vectors
  A = cross(v, w), B = cross(w, u) (alpha = (p-base)//A, beta =
  (p-base)//B — scalar triple product identity applied to plane.h:66-68).
  What remains is ~12 elementwise [R, N] ops (roots, discriminant,
  interior masks), which XLA fuses.

- The winner's HitRecord is joined with ONE one-hot matmul
  [R, N] @ [N, K] against a per-primitive constant table (geometry +
  pre-joined material fields) instead of N-indexed gathers. This is
  O(R x N x K) work where a gather of the winner's row would be O(R x K);
  it stays because it is the measured baseline (PERF.md).

All precomputed tables are built with jnp ops from the Scene pytree
inside the traced function: they are loop-invariant across the depth
scan and spp loop, so XLA hoists them; gradients flow through them to
the underlying scene parameters. Differentiable like the reference path.

The material fields are joined per-primitive here (the reference's
`d_materials[rec.material_idx]` indirection, scene.h:9-21, is resolved
at trace time), so the integrator receives ready material data.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracer.core import vec
from tracer.geometry import plane as plane_mod
from tracer.geometry import sphere as sphere_mod
from tracer.scene.types import K_INFINITY, Scene

T_MIN = 1e-3
T_MAX = 1e30


class JoinedHit(NamedTuple):
    """HitRecord + pre-joined material data (SoA, all [R] / [R, 3])."""

    hit: jnp.ndarray
    t: jnp.ndarray
    point: jnp.ndarray
    normal: jnp.ndarray  # face-oriented unit normal
    front_face: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray
    # material fields (joined through the primitive's material_idx)
    mtype: jnp.ndarray  # [R] i32
    fuzz: jnp.ndarray
    ir: jnp.ndarray
    absorption: jnp.ndarray  # [R, 3]
    albedo: jnp.ndarray  # [R, 3]
    emit: jnp.ndarray  # [R, 3]
    tex_id: jnp.ndarray  # [R] i32


def _material_table(scene: Scene, prim_mat_idx):
    """Per-primitive material columns [N, 12]: mtype, fuzz, ir, abs3,
    albedo3, emit3, tex_id (ints carried exactly as small floats)."""
    m = scene.materials
    return jnp.concatenate(
        [
            m.mtype[prim_mat_idx, None].astype(jnp.float32),
            m.fuzz[prim_mat_idx, None],
            m.ir[prim_mat_idx, None],
            m.absorption[prim_mat_idx],
            m.albedo[prim_mat_idx],
            m.emit[prim_mat_idx],
            m.tex_id[prim_mat_idx, None].astype(jnp.float32),
        ],
        axis=1,
    )


def hit_scene_fast(scene: Scene, origin, direction, t_min=T_MIN, t_max=T_MAX) -> JoinedHit:
    """Nearest hit + material join for [R, 3] ray batches."""
    sph = scene.spheres
    pla = scene.planes
    num_s = scene.num_spheres
    num_p = scene.num_planes
    assert num_s or num_p, "empty scene"
    n = num_s + num_p

    # ---- loop-invariant tables (hoisted out of scan by XLA) -----------
    mats = []
    if num_s:
        mats.append(sph.center)  # [S, 3]
    if num_p:
        a_vec = vec.cross(pla.v, pla.w)  # alpha = phv . A  (plane.h:66)
        b_vec = vec.cross(pla.w, pla.u)  # beta  = phv . B  (plane.h:67)
        mats.extend([pla.normal, a_vec, b_vec])
    proj_mat = jnp.concatenate(mats, axis=0)  # [S + 3P, 3]

    # ---- the two projection matmuls ----------------------------------
    # HIGHEST precision: a GPU's default f32 matmul may run in TF32 (10
    # mantissa bits), which would shift intersection roots by ~1e-3
    # relative and flip silhouette hits vs the brute/oracle path.
    hp = jax.lax.Precision.HIGHEST
    proj_o = jnp.matmul(origin, proj_mat.T, precision=hp)  # [R, S+3P]
    proj_d = jnp.matmul(direction, proj_mat.T, precision=hp)

    a = vec.length_squared(direction)[:, None]  # [R, 1]
    t_parts = []

    if num_s:
        co = proj_o[:, :num_s]
        cd = proj_d[:, :num_s]
        od = jnp.sum(origin * direction, axis=-1, keepdims=True)  # [R, 1]
        oo = vec.length_squared(origin)[:, None]
        cc_rr = (vec.length_squared(sph.center) - sph.radius * sph.radius)[None]  # [1, S]
        half_b = od - cd
        c_term = oo - 2.0 * co + cc_rr
        disc = half_b * half_b - a * c_term
        s_hit = disc >= 0.0
        sqrt_d = vec.sqrt_grad_safe(jnp.where(s_hit, disc, 1.0))  # NaN-safe (see geometry.sphere)
        inv_a = 1.0 / a
        t_near = (-half_b - sqrt_d) * inv_a
        t_far = (-half_b + sqrt_d) * inv_a
        near_ok = s_hit & (t_near >= t_min) & (t_near <= t_max)
        far_ok = s_hit & (t_far >= t_min) & (t_far <= t_max)
        t_parts.append(jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, K_INFINITY)))

    if num_p:
        o_off = num_s
        no = proj_o[:, o_off : o_off + num_p]
        ao = proj_o[:, o_off + num_p : o_off + 2 * num_p]
        bo = proj_o[:, o_off + 2 * num_p :]
        nd = proj_d[:, o_off : o_off + num_p]
        ad = proj_d[:, o_off + num_p : o_off + 2 * num_p]
        bd = proj_d[:, o_off + 2 * num_p :]

        base_a = jnp.sum(pla.base * a_vec, axis=-1)[None]  # [1, P]
        base_b = jnp.sum(pla.base * b_vec, axis=-1)[None]

        denom_ok = jnp.abs(nd) >= plane_mod.DENOM_EPS  # plane.h:59
        safe_nd = jnp.where(denom_ok, nd, 1.0)
        root = (pla.d[None] - no) / safe_nd
        alpha = ao + root * ad - base_a
        beta = bo + root * bd - base_b
        interior = plane_mod.interior_mask(pla.ptype[None], alpha, beta)
        ok = denom_ok & (root >= t_min) & (root <= t_max) & interior
        t_parts.append(jnp.where(ok, root, K_INFINITY))

    t_all = jnp.concatenate(t_parts, axis=1) if len(t_parts) > 1 else t_parts[0]

    # ---- winner + one-hot join -----------------------------------------
    t_best = jnp.min(t_all, axis=1)
    hit = t_best < K_INFINITY
    winner = jnp.argmin(t_all, axis=1)
    onehot = (winner[:, None] == jnp.arange(n)[None, :]).astype(jnp.float32)  # [R, N]

    # join table [N, K]: geometry + material columns
    geo_cols = []
    if num_s:
        geo_cols.append(
            jnp.concatenate(
                [
                    sph.center,  # 0:3
                    sph.radius[:, None],  # 3
                    jnp.zeros((num_s, 3), jnp.float32),  # 4:7 plane normal
                    jnp.ones((num_s, 1), jnp.float32),  # 7 is_sphere
                ],
                axis=1,
            )
        )
    if num_p:
        geo_cols.append(
            jnp.concatenate(
                [
                    jnp.zeros((num_p, 3), jnp.float32),
                    jnp.ones((num_p, 1), jnp.float32),  # radius placeholder (div-safe)
                    pla.normal,
                    jnp.zeros((num_p, 1), jnp.float32),
                ],
                axis=1,
            )
        )
    prim_mat_idx = jnp.concatenate(
        ([sph.material_idx] if num_s else []) + ([pla.material_idx] if num_p else [])
    )
    join = jnp.concatenate(
        [jnp.concatenate(geo_cols, axis=0), _material_table(scene, prim_mat_idx)], axis=1
    )  # [N, 8 + 13]

    rec = jnp.matmul(onehot, join, precision=hp)  # [R, 21]

    center = rec[:, 0:3]
    radius = rec[:, 3]
    plane_normal = rec[:, 4:7]
    is_sphere = rec[:, 7] > 0.5
    mtype = jnp.round(rec[:, 8]).astype(jnp.int32)
    fuzz = rec[:, 9]
    ir = rec[:, 10]
    absorption = rec[:, 11:14]
    albedo = rec[:, 14:17]
    emit = rec[:, 17:20]
    tex_id = jnp.round(rec[:, 20]).astype(jnp.int32)

    # ---- record reconstruction (miss lanes sanitized; see hit.py) ------
    t_calc = jnp.where(hit, t_best, 1.0)
    point = origin + t_calc[:, None] * direction

    outward = (point - center) / jnp.where(is_sphere, radius, 1.0)[:, None]
    raw_normal = jnp.where(is_sphere[:, None], outward, plane_normal)
    front_face = jnp.sum(direction * raw_normal, axis=-1) < 0.0
    normal = jnp.where(front_face[:, None], raw_normal, -raw_normal)

    s_u, s_v = sphere_mod.sphere_uv(outward)
    # plane uv: winner's alpha/beta joined via the same one-hot (only the
    # plane block contributes; sphere rows are zero there).
    if num_p:
        oh_p = onehot[:, num_s:]
        p_u = jnp.sum(oh_p * alpha, axis=1)
        p_v = jnp.sum(oh_p * beta, axis=1)
    else:
        p_u = jnp.zeros_like(s_u)
        p_v = jnp.zeros_like(s_v)
    u = jnp.where(is_sphere, s_u, p_u)
    v = jnp.where(is_sphere, s_v, p_v)

    return JoinedHit(
        hit=hit,
        t=t_best,
        point=point,
        normal=normal,
        front_face=front_face,
        u=u,
        v=v,
        mtype=mtype,
        fuzz=fuzz,
        ir=ir,
        absorption=absorption,
        albedo=albedo,
        emit=emit,
        tex_id=tex_id,
    )
