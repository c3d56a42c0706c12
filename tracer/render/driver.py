"""Animation frame driver: camera path, per-frame timing TSV, savers.

Array-program analog of reference `gpu_render` / `cpu_render`
(src/camera.cu:290-394): a sequential frame loop evaluating the
sinusoidal camera path, rendering with the jitted frame renderer (the
compile is amortized across frames — same shapes), timing each frame
with `block_until_ready` (the cudaEvent analog, camera.cu:333-343), and
printing the identical `frame \t ms \t total_rays` TSV (camera.cu:344-346)
from which Mrays/s is derived offline.
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np

from tracer.io import image as image_io
from tracer.render import camera as camera_mod
from tracer.render import renderer
from tracer.scene.params import SceneParams
from tracer.scene.types import Scene


def render_animation(
    scene: Scene,
    params: SceneParams,
    intersector: str = "fast",
    saver: str = "bin",
    out=None,
    reference_quirk: bool = True,
    chunk: int = renderer.DEFAULT_CHUNK,
    frames=None,
    early_exit: bool = True,
    saver_spp_quirk: bool = True,
    mesh=None,
    rng_mode: str = "fixed",
    stratify: bool = False,
    retries: int = 0,
    rr_start=None,
):
    """Render `params.num_frames` frames; returns the last framebuffer.

    `saver` picks the output writer ('bin' matches the reference drivers,
    camera.cu:300; 'png'/'ppm' also available). The timing TSV goes to
    `out` (default: the current sys.stdout). `frames` optionally
    restricts to an iterable of frame indices.

    `saver_spp_quirk`: the reference drivers construct their savers with
    sqrt_rays_per_pixel while accumulating sqrt_spp^2 samples
    (camera.cu:300/357 vs :319-320), so reference image bytes are
    quantize(sum / sqrt_spp) — over-bright by sqrt(spp) in linear terms.
    True (default) replicates that for byte parity with reference
    output; False divides by the true sample count.

    `mesh`: optional jax.sharding.Mesh — tile-shards each frame over it
    (tracer.dist.sharding) instead of the single-device renderer.
    """
    out = out or sys.stdout
    sqrt_spp = params.render.sqrt_rays_per_pixel
    spp = sqrt_spp * sqrt_spp  # camera.cu:319-320
    saver_divisor = sqrt_spp if saver_spp_quirk else spp
    width, height = params.width, params.height
    writer = image_io.SAVERS[saver]
    rays = renderer.total_rays(width, height, sqrt_spp)

    # Async writer: quantize + encode + disk write happen on a background
    # thread so the accelerator starts frame n+1 while frame n is being
    # written (the reference writes synchronously in-loop,
    # camera.cu:211-215). bin/ppm use the native C++ writer when built;
    # png (and any native-less install) uses the Python thread writer.
    async_writer = None
    if saver in ("bin", "ppm"):
        try:
            from tracer.io import native as io_native

            if io_native.available():
                async_writer = io_native.AsyncFrameWriter()
        except Exception:
            async_writer = None
    if async_writer is None:
        async_writer = image_io.ThreadedWriter()

    fb = None
    frame_iter = range(params.num_frames) if frames is None else frames
    for n in frame_iter:
        # one-dispatch fused path eval + camera build (camera.cu:303-324)
        cam = camera_mod.camera_at(
            params.camera_path, n, params.num_frames, width, height,
            params.fov_degrees, background=(0.0, 0.0, 0.0),  # camera.cu:323
        )
        t0 = time.perf_counter()

        def render_frame_once():
            if mesh is not None:
                from tracer.dist import sharding

                fb_dev = sharding.render_frame_sharded(
                    scene, cam, width, height, spp,
                    params.render.max_depth, mesh,
                    intersector=intersector, reference_quirk=reference_quirk,
                    chunk=chunk, rng_mode=rng_mode, stratify=stratify,
                    rr_start=rr_start,
                )
            else:
                fb_dev = renderer.render_frame(
                    scene, cam, width, height, spp=spp,
                    max_depth=params.render.max_depth, intersector=intersector,
                    reference_quirk=reference_quirk, chunk=chunk, early_exit=early_exit,
                    rng_mode=rng_mode, stratify=stratify, rr_start=rr_start,
                )
            return jax.block_until_ready(fb_dev)  # cudaEvent analog

        if retries > 0:
            # ride through transient backend failures (a lost worker or
            # connection) — the reference has no failure story at all
            from tracer.utils import resilience

            fb_dev = resilience.retry_transient(
                render_frame_once, retries=retries,
                on_retry=lambda k, e: print(
                    f"tracer: frame {n} transient backend failure "
                    f"(retry {k}): {str(e).splitlines()[0][:120]}",
                    file=sys.stderr),
            )
        else:
            fb_dev = render_frame_once()
        ms = (time.perf_counter() - t0) * 1e3
        print(f"{n}\t{ms}\t{rays}", file=out)

        fb = np.asarray(fb_dev)
        try:
            filename = params.output_path % n  # snprintf(path, n), camera.cu:298-300
        except TypeError:
            filename = params.output_path
        if async_writer is not None:
            async_writer.submit(filename, fb, saver_divisor, fmt=saver)
        else:
            writer(filename, fb, saver_divisor)
    if async_writer is not None:
        # close() drains + re-raises worker errors AND always joins the
        # thread (a separate wait() first would skip cleanup on error)
        async_writer.close()
    return fb
