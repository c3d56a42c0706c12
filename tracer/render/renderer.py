"""Frame renderer: pixel-grid ray generation, spp accumulation, chunking.

Array form of reference `render_kernel` (src/camera.cu:17-34): the
CUDA 16x16-block pixel grid becomes a flat ray batch processed in fixed
chunks via `lax.map` (bounding peak memory for the dense [R, prims]
intersection matrices), with the spp loop as a `lax.scan` inside the
chunk for locality. The framebuffer holds RAW sample sums (un-averaged),
exactly like the reference (camera.cu:33); savers divide by spp.

`render_pixels` is the shard-local core — tracer.dist shards its pixel
axis over a device mesh.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracer.core import rng
from tracer.render import camera as camera_mod
from tracer.render import integrator
from tracer.scene.types import Scene

DEFAULT_CHUNK = 16384


def render_pixels(
    scene: Scene,
    cam: camera_mod.CameraData,
    i_flat,
    j_flat,
    base_seed,
    spp: int,
    max_depth: int,
    intersector: str = "fast",
    chunk: int = DEFAULT_CHUNK,
    early_exit: bool = False,
    sample_start: int = 0,
    rng_mode: str = "fixed",
    stratify: bool = False,
    strat_sqrt_spp: int = 0,
    rr_start=None,
):
    """Raw sample sums [N, 3] for a flat list of pixels.

    `strat_sqrt_spp` overrides the stratification grid size (needed when
    the sample axis is sharded: each device renders a slice of the
    GLOBAL sample range, so cells derive from the global sqrt(spp)).

    `stratify=True` confines each sample's pixel jitter to its cell of a
    sqrt(spp) x sqrt(spp) sub-pixel grid (spp must be a perfect square) —
    lower-variance anti-aliasing than the reference's uniform jitter.

    `sample_start` offsets the sample index range to [start, start+spp)
    — used by spp-axis sharding (each device takes a disjoint slice of
    the per-pixel sample stream, reference camera.cu:27-31 semantics).

    i_flat/j_flat: [N] u32 pixel column/row; base_seed: [N] u32 per-pixel
    seed (reference camera.cu:25). The pixel axis is processed in
    `chunk`-sized blocks (a sequential lax.map bounding the [chunk, prims]
    working set); spp accumulates in a scan per block (camera.cu:27-31).
    """
    n = i_flat.shape[0]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        i_flat = jnp.pad(i_flat, (0, pad))
        j_flat = jnp.pad(j_flat, (0, pad))
        base_seed = jnp.pad(base_seed, (0, pad))
    num_chunks = (n + pad) // chunk

    sqrt_spp = 0
    if stratify:
        sqrt_spp = strat_sqrt_spp or int(round(spp ** 0.5))
        assert strat_sqrt_spp or sqrt_spp * sqrt_spp == spp, (
            "stratify requires square spp (or an explicit strat_sqrt_spp)"
        )

    def one_sample(i, j, base, s):
        seed = rng.sample_seed(base, s)
        seed, origin, direction = camera_mod.get_rays(
            cam, i, j, seed, sample_index=s if stratify else None, sqrt_spp=sqrt_spp
        )
        color, _ = integrator.trace(
            scene, cam.background, origin, direction, seed, max_depth,
            intersector=intersector, early_exit=early_exit, rng_mode=rng_mode,
            rr_start=rr_start,
        )
        return color

    # Recompute each sample in the backward pass instead of saving every
    # bounce's residuals for all spp iterations (remat over the spp scan).
    one_sample = jax.checkpoint(one_sample)

    def per_chunk(args):
        i, j, base = args

        def body(acc, s):
            return acc + one_sample(i, j, base, s), None

        # zeros_like(i, ...) keeps the shard_map varying-axes type of the
        # pixel batch (a fresh jnp.zeros would be 'unvarying' and clash).
        acc0 = jnp.zeros_like(i, dtype=jnp.float32, shape=(chunk, 3))
        # sample_start may be a traced per-device offset (spp sharding)
        samples = jnp.arange(spp, dtype=jnp.uint32) + jnp.uint32(sample_start)
        acc, _ = jax.lax.scan(body, acc0, samples)
        return acc

    i_c = i_flat.reshape(num_chunks, chunk)
    j_c = j_flat.reshape(num_chunks, chunk)
    seed_c = base_seed.reshape(num_chunks, chunk)
    fb = jax.lax.map(per_chunk, (i_c, j_c, seed_c)).reshape(-1, 3)
    return fb[:n]


def pixel_grid(width: int, height: int, reference_quirk: bool = True):
    """Flat pixel index arrays (i=column, j=row) and per-pixel base seeds.

    Seeding matches the reference: wang_hash(i*width + j) (camera.cu:25,
    the i*width+j quirk — SURVEY.md §7(e); reference_quirk=False uses the
    corrected row-major layout)."""
    jj, ii = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.uint32),
        jnp.arange(width, dtype=jnp.uint32),
        indexing="ij",
    )
    i_flat = ii.reshape(-1)
    j_flat = jj.reshape(-1)
    base_seed = rng.pixel_seed(i_flat, j_flat, width, reference_quirk=reference_quirk)
    return i_flat, j_flat, base_seed


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "intersector", "reference_quirk", "chunk", "early_exit", "rng_mode", "stratify", "rr_start"),
)
def render_frame(
    scene: Scene,
    cam: camera_mod.CameraData,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    intersector: str = "fast",
    reference_quirk: bool = True,
    chunk: int = DEFAULT_CHUNK,
    early_exit: bool = False,
    rng_mode: str = "fixed",
    stratify: bool = False,
    rr_start=None,
    sample_start=0,
):
    """Render one frame; returns [height, width, 3] raw sample sums.

    rr_start (int, default None=off): throughput Russian roulette from
    that bounce index on (see integrator._bounce) — unbiased deep-scene
    acceleration.

    sample_start (traced): first global sample index, so a frame can be
    rendered as a sum of spp chunks (see tracer.opt.grads).

    early_exit=True stops the bounce loop as soon as a whole pixel chunk
    has terminated (forward-only; see integrator.trace)."""
    i_flat, j_flat, base_seed = pixel_grid(width, height, reference_quirk)
    fb = render_pixels(
        scene, cam, i_flat, j_flat, base_seed, spp, max_depth,
        intersector=intersector, chunk=chunk, early_exit=early_exit,
        rng_mode=rng_mode, stratify=stratify, rr_start=rr_start,
        sample_start=sample_start,
    )
    return fb.reshape(height, width, 3)


def total_rays(width: int, height: int, sqrt_spp: int) -> int:
    """reference camera.cu:344-345: width*height*sqrt_spp^2."""
    return width * height * sqrt_spp * sqrt_spp
