"""Multi-device / multi-host rendering: pixel tiles sharded over a Mesh.

The reference is strictly single-GPU (SURVEY.md §2: data-parallel over
pixels within one kernel launch, no inter-device code). The scaling
design here (SURVEY.md §5, §7 stage 7):

- 1D device mesh with axis 'tiles'; the flat pixel axis is sharded
  across it (`P('tiles')`), scene + camera pytrees are replicated.
- Forward rendering needs ZERO communication: every device shades its
  own pixels against the replicated scene (the tiny ~KB scene rides
  free in device memory everywhere).
- Backward: the transpose of replicated-scene broadcast is a `psum` of
  per-device scene gradients — inserted automatically when
  differentiating through `shard_map` (NCCL over NVLink on one host).
- Multi-host: the same code runs under `jax.distributed.initialize()`;
  the mesh spans all hosts' devices.

Every device reaches every other at the same rate, so the mesh is 1-D
and follows the pixel axis alone. Tested on a virtual 8-device CPU mesh
(tests/conftest.py) per the multi-host test strategy in SURVEY.md §4.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from tracer.opt import grads
from tracer.render import camera as camera_mod
from tracer.render import renderer
from tracer.scene.types import Scene

AXIS = "tiles"


def _to_varying(x):
    """Mark a replicated value as device-varying inside shard_map."""
    if not hasattr(x, "dtype"):
        return x
    return jax.lax.pcast(x, (AXIS,), to="varying")


def make_mesh(devices=None) -> Mesh:
    """1D mesh over all (or the given) devices."""
    import numpy as np

    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (AXIS,))


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "intersector", "reference_quirk", "chunk", "mesh", "rng_mode", "stratify", "rr_start"),
)
def render_frame_sharded(
    scene: Scene,
    cam: camera_mod.CameraData,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    mesh: Mesh,
    intersector: str = "fast",
    reference_quirk: bool = True,
    chunk: int = renderer.DEFAULT_CHUNK,
    rng_mode: str = "fixed",
    stratify: bool = False,
    rr_start=None,
    sample_start=0,
):
    """Sharded frame render; returns [height, width, 3] raw sample sums.

    Bit-identical to the single-device renderer.render_frame — sharding
    only partitions the pixel axis; seeds are per-pixel so the split
    point is invisible to the result. `sample_start` (traced) offsets the
    global sample range, as in renderer.render_frame.
    """
    n_dev = mesh.devices.size
    i_flat, j_flat, base_seed = renderer.pixel_grid(width, height, reference_quirk)
    n = i_flat.shape[0]
    pad = (-n) % n_dev
    if pad:
        i_flat = jnp.pad(i_flat, (0, pad))
        j_flat = jnp.pad(j_flat, (0, pad))
        base_seed = jnp.pad(base_seed, (0, pad))
    local_chunk = min(chunk, (n + pad) // n_dev)

    def shard_body(scene, cam, i, j, base, start):
        # Mark the replicated scene/camera as device-varying: keeps the
        # scan-carry vma types consistent inside the shard, and makes the
        # transpose of this broadcast a psum of per-device scene grads —
        # the cross-device gradient all-reduce, inserted by autodiff.
        scene, cam, start = jax.tree.map(_to_varying, (scene, cam, start))
        return renderer.render_pixels(
            scene, cam, i, j, base, spp, max_depth,
            intersector=intersector, chunk=local_chunk, sample_start=start,
            rng_mode=rng_mode, stratify=stratify, rr_start=rr_start,
        )

    fb = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(AXIS), P(AXIS), P(AXIS), P()),
        out_specs=P(AXIS),
    )(scene, cam, i_flat, j_flat, base_seed, jnp.int32(sample_start))
    return fb[:n].reshape(height, width, 3)


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "intersector", "reference_quirk", "chunk", "mesh", "rng_mode", "stratify", "rr_start"),
)
def render_frame_spp_sharded(
    scene: Scene,
    cam: camera_mod.CameraData,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    mesh: Mesh,
    intersector: str = "fast",
    reference_quirk: bool = True,
    chunk: int = renderer.DEFAULT_CHUNK,
    rng_mode: str = "fixed",
    stratify: bool = False,
    rr_start=None,
):
    """Sample-axis sharding (SURVEY.md §2 parallelism table): every device
    renders ALL pixels with a disjoint slice of the per-pixel sample
    stream, and the raw sums psum over the mesh. Useful when the image is
    too small to fill the mesh with pixels. Requires spp % n_devices == 0.
    Bit-identical to the single-device renderer (sample sums are an
    order-free reduction... up to f32 addition order)."""
    n_dev = mesh.devices.size
    assert spp % n_dev == 0, f"spp {spp} must divide across {n_dev} devices"
    local_spp = spp // n_dev
    strat_sqrt = int(round(spp ** 0.5)) if stratify else 0
    if stratify:
        assert strat_sqrt * strat_sqrt == spp, "stratify requires square spp"
    i_flat, j_flat, base_seed = renderer.pixel_grid(width, height, reference_quirk)

    def shard_body(scene, cam, i, j, base):
        scene, cam, i, j, base = jax.tree.map(_to_varying, (scene, cam, i, j, base))
        start = jax.lax.axis_index(AXIS) * local_spp
        part = renderer.render_pixels(
            scene, cam, i, j, base, local_spp, max_depth,
            intersector=intersector, chunk=min(chunk, i.shape[0]),
            sample_start=start, rng_mode=rng_mode, stratify=stratify,
            strat_sqrt_spp=strat_sqrt, rr_start=rr_start,
        )
        return jax.lax.psum(part, AXIS)

    fb = jax.shard_map(
        shard_body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=P(),
    )(scene, cam, i_flat, j_flat, base_seed)
    return fb.reshape(height, width, 3)


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "mesh",
                     "reference_quirk", "rr_start", "chunk"),
)
def _chunk_grads_sharded(scene, cam, g_fb, sample_start, width, height, spp,
                         max_depth, mesh, reference_quirk, rr_start, chunk):
    """(d(scene), d(cam)) of one spp chunk of the sharded render for the
    frame cotangent g_fb; the shard_map transpose psums the per-device
    scene/camera cotangents."""

    def render(scene, cam):
        return render_frame_sharded(
            scene, cam, width, height, spp, max_depth, mesh,
            reference_quirk=reference_quirk, chunk=chunk, rr_start=rr_start,
            sample_start=sample_start,
        )

    _, vjp = jax.vjp(render, scene, cam)
    return vjp(g_fb)


def l2_grads_deep_sharded(
    scene: Scene,
    cam: camera_mod.CameraData,
    target,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    mesh: Mesh,
    spp_chunk=None,
    reference_quirk: bool = True,
    rr_start=None,
    chunk: int = renderer.DEFAULT_CHUNK,
):
    """(loss, d(scene), d(cam)) for mean((fb/spp - target)^2), pixel tiles
    sharded over `mesh` and the backward run in spp chunks — the BASELINE
    config-5 runner (2K spheres, 4K render, tiles sharded, grads on all
    scene params). Same method as tracer.opt.grads.l2_grads_deep, whose
    results it matches up to f32 reduction order."""
    fb = render_frame_sharded(
        scene, cam, width, height, spp, max_depth, mesh,
        reference_quirk=reference_quirk, chunk=chunk, rr_start=rr_start,
    )
    loss, g_fb = grads.l2_loss_and_cotangent(fb, target, spp)
    g_scene, g_cam = grads.sum_chunk_cotangents(
        lambda start, n: _chunk_grads_sharded(
            scene, cam, g_fb, start, width, height, n, max_depth, mesh,
            reference_quirk, rr_start, chunk),
        spp, spp_chunk,
    )
    return loss, g_scene, g_cam


def scene_grads_sharded(
    scene: Scene,
    cam: camera_mod.CameraData,
    target,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    mesh: Mesh,
    intersector: str = "fast",
):
    """L2-loss gradient of a sharded render w.r.t. the whole scene pytree.

    The per-device partial gradients of the replicated scene are psum'd
    across the mesh by the shard_map transpose — this is the reference's
    missing 'distributed backend' slot (SURVEY.md §2) done the XLA way.
    Returns (loss, grads) with grads a Scene-shaped pytree.
    """

    def loss_fn(scene):
        fb = render_frame_sharded(
            scene, cam, width, height, spp, max_depth, mesh, intersector=intersector
        )
        return jnp.mean((fb / spp - target) ** 2)

    # allow_int: index/type fields of the Scene pytree get float0 tangents.
    return jax.value_and_grad(loss_fn, allow_int=True)(scene)
