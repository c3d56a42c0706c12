"""L2 image-loss gradients at any depth, with the backward in spp chunks.

The framebuffer holds raw sample sums, so fb = sum over spp chunks of
each chunk's frame, and every chunk's output cotangent is the frame
cotangent g_fb unchanged. `l2_grads_deep` renders the frame once for
the loss and g_fb, then runs `jax.vjp` of each chunk's render (offset
by `sample_start`) on that fixed g_fb and sums the cotangents.

The renderer rematerializes every sample in its backward pass
(renderer.render_pixels), so the memory of one VJP does not grow with
spp; `spp_chunk` only splits the backward into several programs. The
default is one chunk.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from tracer.render import camera as camera_mod
from tracer.render import renderer
from tracer.scene.types import Scene


def l2_loss_and_cotangent(fb, target, spp: int):
    """(mean((fb/spp - target)^2), d loss / d fb) for raw sample sums fb."""
    target = jnp.asarray(target, jnp.float32)

    def loss_of(fb):
        return jnp.mean((fb / spp - target) ** 2)

    loss, loss_vjp = jax.vjp(loss_of, fb)
    (g_fb,) = loss_vjp(jnp.ones((), jnp.float32))
    return loss, g_fb


def _add_cotangent(a, b):
    if a.dtype == jax.dtypes.float0:
        return a  # integer leaves (mtype, indices) carry float0 cotangents
    return a + b


def sum_chunk_cotangents(chunk_grads, spp: int, spp_chunk=None):
    """Sum `chunk_grads(sample_start, n)` over the chunks of [0, spp).

    `spp_chunk=None` means one chunk of all spp."""
    spp_chunk = spp_chunk or spp
    if spp % spp_chunk:
        raise ValueError(f"spp {spp} is not a multiple of spp_chunk {spp_chunk}")
    total = None
    for start in range(0, spp, spp_chunk):
        g = chunk_grads(jnp.int32(start), spp_chunk)
        total = g if total is None else jax.tree.map(_add_cotangent, total, g)
    return total


@partial(
    jax.jit,
    static_argnames=("width", "height", "spp", "max_depth", "reference_quirk",
                     "rr_start", "chunk"),
)
def _chunk_grads(scene, cam, g_fb, sample_start, width, height, spp, max_depth,
                 reference_quirk, rr_start, chunk):
    """(d(scene), d(cam)) of one spp chunk's render for cotangent g_fb."""

    def render(scene, cam):
        return renderer.render_frame(
            scene, cam, width, height, spp, max_depth,
            reference_quirk=reference_quirk, chunk=chunk, rr_start=rr_start,
            sample_start=sample_start,
        )

    _, vjp = jax.vjp(render, scene, cam)
    return vjp(g_fb)


def l2_grads_deep(
    scene: Scene,
    cam: camera_mod.CameraData,
    target,
    width: int,
    height: int,
    spp: int,
    max_depth: int,
    spp_chunk=None,
    reference_quirk: bool = True,
    rr_start=None,
    chunk: int = renderer.DEFAULT_CHUNK,
):
    """(loss, d(scene), d(cam)) for mean((fb/spp - target)^2).

    Cost is one forward frame plus one forward+backward per sample,
    whatever `spp_chunk` is. Gradients match jax.grad of the same loss
    up to f32 addition order."""
    fb = renderer.render_frame(
        scene, cam, width, height, spp, max_depth,
        reference_quirk=reference_quirk, chunk=chunk, rr_start=rr_start,
    )
    loss, g_fb = l2_loss_and_cotangent(fb, target, spp)
    g_scene, g_cam = sum_chunk_cotangents(
        lambda start, n: _chunk_grads(
            scene, cam, g_fb, start, width, height, n, max_depth,
            reference_quirk, rr_start, chunk),
        spp, spp_chunk,
    )
    return loss, g_scene, g_cam
