"""BVH traversal for ray batches: short-stack `lax.while_loop`.

Batched form of reference `hit_bvh` (include/bvh.h:19-65): the per-
thread `int stack[32]` becomes a `[R, D]` stack array carried through a
single batched while_loop — every lane advances together, lanes with an
empty stack idle until all finish (the SIMD analog of warp divergence).
Near-child-first ordering uses the REAL stored split axis (the reference
reads `type` as the axis, bvh.h:52, which is -1 for internal nodes — a
latent bug we fix per SURVEY.md §2 L3).

Differentiability: traversal is discrete (which primitive wins), so it
runs under stop_gradient and returns only indices + a hit flag; the
winning primitive's t and HitRecord are then RECOMPUTED differentiably
from the gathered primitive data (tracer.render.hit._winner_record).
This is the straight-through convention of SURVEY.md §7 stage 6.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from tracer.geometry import aabb as aabb_mod
from tracer.geometry import plane as plane_mod
from tracer.geometry import sphere as sphere_mod
from tracer.render import hit as hit_mod
from tracer.scene.types import K_INFINITY, Scene


def _stack_depth(num_nodes: int) -> int:
    """Median-split trees are balanced: depth <= ceil(log2(leaves)) + 2."""
    leaves = max(1, (num_nodes + 1) // 2)
    return max(4, int(math.ceil(math.log2(leaves))) + 3)


def traverse(scene: Scene, origin, direction, t_min, t_max):
    """Nearest-hit primitive per ray via the BVH.

    Returns (hit[R] bool, is_sphere[R] bool, prim_idx[R] i32, t[R] f32).
    All geometry inputs pass through stop_gradient — callers recompute t
    differentiably for the winner.
    """
    bvh = scene.bvh
    assert bvh is not None, "scene.bvh is not built (use builders.create_scene(with_bvh=True))"
    origin = jax.lax.stop_gradient(origin)
    direction = jax.lax.stop_gradient(direction)
    sph = jax.lax.stop_gradient(scene.spheres)
    pla = jax.lax.stop_gradient(scene.planes)
    box_min = jax.lax.stop_gradient(bvh.box_min)
    box_max = jax.lax.stop_gradient(bvh.box_max)

    num_nodes = bvh.left.shape[0]
    depth = _stack_depth(num_nodes)
    r = origin.shape[0]

    # The initial state derives from the ray batch (zeros_like), so under
    # shard_map its varying-axes type matches the loop's output.
    zeros_i = jnp.zeros_like(origin[:, 0], dtype=jnp.int32)
    stack = jnp.zeros_like(zeros_i, shape=(r, depth))  # root (node 0) pre-pushed
    sp = zeros_i + 1
    closest = jnp.zeros_like(origin[:, 0]) + jnp.float32(t_max)
    best_sphere = zeros_i != 0
    best_idx = zeros_i
    found = zeros_i != 0

    has_spheres = scene.num_spheres > 0
    has_planes = scene.num_planes > 0

    def cond(state):
        _, sp, *_ = state
        return jnp.any(sp > 0)

    def body(state):
        stack, sp, closest, best_sphere, best_idx, found = state
        active = sp > 0
        top = jnp.maximum(sp - 1, 0)
        node = jnp.take_along_axis(stack, top[:, None], axis=1)[:, 0]
        node = jnp.where(active, node, 0)
        sp = jnp.where(active, sp - 1, sp)  # pop (bvh.h:30)

        nmin = box_min[node]
        nmax = box_max[node]
        box_ok = active & aabb_mod.slab_hit(origin, direction, nmin, nmax, t_min, closest)

        left = bvh.left[node]
        right = bvh.right[node]
        kind = bvh.kind[node]
        axis = bvh.axis[node]

        is_leaf = left < 0  # bvh.h:36
        leaf_hit = box_ok & is_leaf

        # --- leaf: intersect the single primitive (bvh.h:37-49) ----------
        if has_spheres:
            s_idx = jnp.where(leaf_hit & (kind == 0), right, 0)
            t_s = sphere_mod.sphere_t_gathered(
                origin, direction, sph.center[s_idx], sph.radius[s_idx],
                t_min, K_INFINITY,
            )
            # interval upper bound is the *running closest* (bvh.h:40)
            s_ok = leaf_hit & (kind == 0) & (t_s <= closest)
        else:
            t_s = jnp.full((r,), K_INFINITY)
            s_ok = jnp.zeros((r,), bool)

        if has_planes:
            p_idx = jnp.where(leaf_hit & (kind == 1), right, 0)
            t_p = plane_mod.plane_t_gathered(
                origin, direction, pla.ptype[p_idx], pla.base[p_idx], pla.u[p_idx],
                pla.v[p_idx], pla.normal[p_idx], pla.d[p_idx], pla.w[p_idx],
                t_min, K_INFINITY,
            )
            p_ok = leaf_hit & (kind == 1) & (t_p <= closest)
        else:
            t_p = jnp.full((r,), K_INFINITY)
            p_ok = jnp.zeros((r,), bool)

        t_prim = jnp.where(s_ok, t_s, jnp.where(p_ok, t_p, K_INFINITY))
        prim_hit = s_ok | p_ok
        closest = jnp.where(prim_hit, t_prim, closest)
        best_sphere = jnp.where(prim_hit, s_ok, best_sphere)
        best_idx = jnp.where(prim_hit, right, best_idx)
        found = found | prim_hit

        # --- internal: push far then near (bvh.h:51-59) -------------------
        push = box_ok & ~is_leaf
        dir_axis = jnp.take_along_axis(direction, axis[:, None], axis=1)[:, 0]
        left_first = dir_axis >= 0.0
        first = jnp.where(left_first, left, right)
        second = jnp.where(left_first, right, left)

        rows = jnp.arange(r)

        def push_one(stack, sp, value, do):
            idx = jnp.minimum(sp, depth - 1)
            cur = stack[rows, idx]
            stack = stack.at[rows, idx].set(jnp.where(do, value, cur))
            sp = jnp.where(do, jnp.minimum(sp + 1, depth), sp)
            return stack, sp

        stack, sp = push_one(stack, sp, second, push)
        stack, sp = push_one(stack, sp, first, push)

        return stack, sp, closest, best_sphere, best_idx, found

    state = (stack, sp, closest, best_sphere, best_idx, found)
    state = jax.lax.while_loop(cond, body, state)
    _, _, closest, best_sphere, best_idx, found = state
    return found, best_sphere, best_idx, closest


def hit_scene_bvh(scene: Scene, origin, direction,
                  t_min=hit_mod.T_MIN, t_max=hit_mod.T_MAX) -> hit_mod.HitRecord:
    """Drop-in replacement for hit_scene_brute via BVH traversal.

    The winner's t is recomputed differentiably from its own primitive
    data (gradients flow to sphere centers/radii and plane vertices even
    though the traversal itself is discrete).
    """
    found, is_sphere, prim_idx, _ = traverse(scene, origin, direction, t_min, t_max)
    r = origin.shape[0]

    # Differentiable t recompute for the winning primitive.
    if scene.num_spheres > 0:
        s_idx = jnp.where(is_sphere, prim_idx, 0)
        t_s = sphere_mod.sphere_t_gathered(
            origin, direction,
            scene.spheres.center[s_idx],
            scene.spheres.radius[s_idx],
            t_min, t_max,
        )
    else:
        s_idx = jnp.zeros((r,), jnp.int32)
        t_s = jnp.full((r,), K_INFINITY)
    if scene.num_planes > 0:
        pla = scene.planes
        p_idx = jnp.where(is_sphere, 0, prim_idx)
        t_p = plane_mod.plane_t_gathered(
            origin, direction, pla.ptype[p_idx], pla.base[p_idx], pla.u[p_idx],
            pla.v[p_idx], pla.normal[p_idx], pla.d[p_idx], pla.w[p_idx],
            t_min, t_max,
        )
    else:
        p_idx = jnp.zeros((r,), jnp.int32)
        t_p = jnp.full((r,), K_INFINITY)

    t_best = jnp.where(is_sphere, t_s, t_p)
    rec = hit_mod._winner_record(
        scene, origin, direction, t_best, found, is_sphere, s_idx, p_idx
    )
    return rec
