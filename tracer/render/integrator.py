"""Path-trace integrator: the reference's per-thread bounce loop as a
masked `lax.scan` over depth.

reference `ray_color` / `ray_color_host` (src/camera.cu:218-288): an
iterative loop with throughput `beta`, early `break` on miss or absorbed
scatter. Early exits become an `alive` mask carried through the scan
(SURVEY.md §7 stage 2); dead lanes keep computing but their state is
frozen, which is the branchless price a vector machine pays.

Three interchangeable intersectors (all produce identical radiance):
  "fast"  - matmul-formulated brute force with one-hot material join
            (tracer.render.hit_fast) — the default.
  "brute" - direct vectorized port (tracer.render.hit) — the readable
            reference implementation the oracle tests pin down.
  "bvh"   - batched BVH traversal (tracer.bvh.traverse) for large scenes.

Fully differentiable w.r.t. the scene pytree and camera (reverse mode
through scan); discrete decisions (hit argmin, material switch, RNG
gates) are piecewise-constant and contribute no gradient, matching the
straight-through convention in SURVEY.md §7 stage 6.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracer.core import rng as rng_mod
from tracer.materials import scatter as scatter_mod
from tracer.materials import texture as texture_mod
from tracer.render import hit as hit_mod
from tracer.render import hit_fast
from tracer.scene.types import Scene

INTERSECTORS = ("fast", "brute", "bvh")
RR_MIN_P = 0.05  # Russian-roulette survival floor


def _joined_hit(scene: Scene, origin, direction, intersector: str):
    """Nearest hit with material fields joined, via any intersector."""
    if intersector == "fast":
        return hit_fast.hit_scene_fast(scene, origin, direction)

    if intersector == "brute":
        rec = hit_mod.hit_scene_brute(scene, origin, direction)
    elif intersector == "bvh":
        from tracer.bvh import traverse as bvh_traverse

        rec = bvh_traverse.hit_scene_bvh(scene, origin, direction)
    else:
        raise ValueError(f"unknown intersector {intersector!r}")

    mats = scene.materials
    midx = rec.material_idx
    return hit_fast.JoinedHit(
        hit=rec.hit,
        t=rec.t,
        point=rec.point,
        normal=rec.normal,
        front_face=rec.front_face,
        u=rec.u,
        v=rec.v,
        mtype=mats.mtype[midx],
        fuzz=mats.fuzz[midx],
        ir=mats.ir[midx],
        absorption=mats.absorption[midx],
        albedo=mats.albedo[midx],
        emit=mats.emit[midx],
        tex_id=mats.tex_id[midx],
    )


def _bounce(scene: Scene, background, carry, intersector: str, rng_mode: str = "fixed",
            rr_start=None, depth=None):
    origin, direction, beta, final, seed, alive = carry

    rec = _joined_hit(scene, origin, direction, intersector)

    # Miss: final += beta * background, path dies (camera.cu:226-229).
    miss = alive & ~rec.hit
    final = final + jnp.where(miss[..., None], beta * background, 0.0)

    active = alive & rec.hit

    # Texture-modulated albedo (camera.cu:233-236 / :269-271).
    albedo = rec.albedo
    if scene.textures is not None:
        tex_rgb = texture_mod.sample_bilinear(scene.textures, rec.tex_id, rec.u, rec.v)
        albedo = jnp.where((rec.tex_id >= 0)[..., None], albedo * tex_rgb, albedo)

    # Emission before scatter (camera.cu:237-238).
    final = final + jnp.where(active[..., None], beta * rec.emit, 0.0)

    # Scatter (camera.cu:240-244). Seeds advance on every lane each bounce
    # (fixed 8-draw budget) so streams stay uniform across the batch.
    scatter_fn = (
        scatter_mod.scatter_reference if rng_mode == "reference" else scatter_mod.scatter
    )
    seed, new_origin, new_dir, attenuation, ok = scatter_fn(
        origin, direction, rec.point, rec.normal, rec.front_face,
        rec.mtype, rec.fuzz, rec.ir, rec.absorption, albedo, seed,
    )

    live = active & ok
    beta = jnp.where(live[..., None], beta * attenuation, beta)
    origin = jnp.where(live[..., None], new_origin, origin)
    direction = jnp.where(live[..., None], new_dir, direction)

    if rr_start is not None:
        # Opt-in throughput Russian roulette from bounce index rr_start
        # on (generalizes the reference's dielectric-only roulette,
        # materials.h:123-125): kill with probability 1 - max(beta),
        # rescale survivors by 1/p — unbiased (one extra draw per
        # bounce, every lane, after the scatter budget).
        seed, u_t = rng_mod.random_float(seed)
        p = jnp.clip(jnp.max(beta, axis=-1), RR_MIN_P, 1.0)
        do = live & (depth >= rr_start)
        kill = do & (u_t >= p)
        scale = jnp.where(do & ~kill, 1.0 / p, 1.0)
        beta = beta * scale[..., None]
        live = live & ~kill

    return (origin, direction, beta, final, seed, live)


@partial(jax.jit, static_argnames=("max_depth", "intersector", "early_exit", "rng_mode",
                                   "rr_start"))
def trace(
    scene: Scene,
    background,
    origin,
    direction,
    seed,
    max_depth: int,
    intersector: str = "fast",
    early_exit: bool = False,
    rng_mode: str = "fixed",
    rr_start=None,
):
    """Radiance for a batch of rays.

    Args:
      scene: replicated Scene pytree.
      background: [3] f32 (reference camera background, black by default).
      origin, direction: [R, 3] primary rays.
      seed: [R] u32, already advanced past ray generation.
      max_depth: static bounce cap (reference camera.cu:223).
      intersector: "fast" (matmul brute force), "brute" (reference port),
        or "bvh" (scene.bvh must be built).
      rng_mode: "fixed" (8-draw budget per bounce, a stream uniform
        across the batch) or "reference" (per-lane
        streams advance exactly like the reference binary — rejection
        sampling + conditional consumption; see scatter_reference).
      early_exit: run the depth loop as a while_loop that stops as soon as
        every ray in the batch has terminated — the vectorized analog of
        the reference's per-thread `break` (camera.cu:228). Forward-only:
        while_loop is not reverse-differentiable, so gradient paths use
        the masked scan (early_exit=False).

    Returns (final_color [R, 3], seed [R]).
    """
    # Derive the carry inits from the ray arrays (ones_like/comparison)
    # rather than fresh constants so their varying-manual-axes types match
    # under shard_map (a fresh jnp.ones is 'unvarying' and would clash
    # with the varying carry output on the device-sharded pixel axis).
    beta = jnp.ones_like(origin)
    final = jnp.zeros_like(origin)
    alive = seed == seed  # all-True, vma-consistent with the ray batch
    carry = (origin, direction, beta, final, seed, alive)

    if rr_start is not None and rng_mode != "fixed":
        raise ValueError("rr_start requires the fixed-budget RNG stream")

    if early_exit:
        def cond(state):
            depth, carry = state
            return (depth < max_depth) & jnp.any(carry[-1])

        def body(state):
            depth, carry = state
            return depth + 1, _bounce(scene, background, carry, intersector, rng_mode,
                                      rr_start=rr_start, depth=depth)

        _, carry = jax.lax.while_loop(cond, body, (jnp.int32(0), carry))
    else:
        def body(carry, depth):
            return _bounce(scene, background, carry, intersector, rng_mode,
                           rr_start=rr_start, depth=depth), None

        carry, _ = jax.lax.scan(body, carry, jnp.arange(max_depth), length=max_depth)
    _, _, _, final, seed, _ = carry
    return final, seed
