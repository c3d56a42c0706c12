"""Multi-host orchestration: cluster initialization and frame/tile work
splitting.

The reference is a one-GPU, one-process renderer; its scaling axes
(image size x spp) all live inside one kernel launch (SURVEY.md §2).
The multi-host design has two independent levers:

- TILE sharding (within a frame): the global mesh spans every device of
  every host; `sharding.render_frame_sharded` partitions the pixel axis
  and XLA routes any collective over NVLink within a host and the
  network across hosts. Used when a single frame must go fast.
- FRAME sharding (across frames): frames are embarrassingly parallel
  (independent output files, camera.cu:297-300), so hosts round-robin
  whole frames with zero communication, each tile-sharding its frames
  over its LOCAL devices. Used for animation throughput.

Both compose with gradient fitting: scene-parameter gradients psum over
the global mesh (sharding.scene_grads_sharded).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """jax.distributed.initialize with env-var fallbacks.

    Set COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID or pass the
    arguments explicitly.
    Safe to call in single-process runs (no-op on failure to detect).
    """
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except Exception:
        if num_processes not in (None, 1):
            raise  # explicit multi-process setup must not silently degrade


def my_frames(num_frames: int, process_id: Optional[int] = None,
              num_processes: Optional[int] = None) -> list:
    """Round-robin frame assignment for this host (frame sharding)."""
    pid = jax.process_index() if process_id is None else process_id
    n = jax.process_count() if num_processes is None else num_processes
    return [f for f in range(num_frames) if f % n == pid]


def render_animation_multihost(scene, params, frame_shard: bool = True, **kwargs):
    """Render an animation across hosts.

    frame_shard=True: each host renders its round-robin subset of frames,
    tile-sharded over its LOCAL devices (zero cross-host traffic; every
    host writes only its own frames' files).

    frame_shard=False: every frame is tile-sharded over the GLOBAL mesh
    spanning all hosts (jax.distributed must be initialized); the
    framebuffer is allgathered so host 0 can write output files, and
    only process 0 writes.
    """
    from tracer.dist import sharding
    from tracer.render import driver

    if frame_shard:
        mesh = sharding.make_mesh(jax.local_devices())
        return driver.render_animation(
            scene, params, frames=my_frames(params.num_frames),
            mesh=mesh if mesh.devices.size > 1 else None, **kwargs,
        )

    mesh = sharding.make_mesh(jax.devices())
    if jax.process_count() == 1:
        return driver.render_animation(scene, params, mesh=mesh, **kwargs)

    # Multi-process global mesh: render via the sharded path ourselves so
    # the distributed framebuffer can be allgathered before saving.
    import numpy as np
    from jax.experimental import multihost_utils

    from tracer.io import image as image_io
    from tracer.render import camera as camera_mod
    import sys
    import time

    sqrt_spp = params.render.sqrt_rays_per_pixel
    spp = sqrt_spp * sqrt_spp
    divisor = sqrt_spp if kwargs.get("saver_spp_quirk", True) else spp
    writer = image_io.SAVERS[kwargs.get("saver", "bin")]
    out = kwargs.get("out", sys.stdout)
    rays = params.width * params.height * spp

    fb_np = None
    for n in range(params.num_frames):
        lookfrom, lookat = camera_mod.camera_path_position(
            params.camera_path, n, params.num_frames
        )
        cam = camera_mod.build_camera_data(
            origin=lookfrom, look_at=lookat, width=params.width,
            height=params.height, vfov=params.fov_degrees,
        )
        t0 = time.perf_counter()
        fb = sharding.render_frame_sharded(
            scene, cam, params.width, params.height, spp,
            params.render.max_depth, mesh,
            intersector=kwargs.get("intersector", "fast"),
            reference_quirk=kwargs.get("reference_quirk", True),
            chunk=kwargs.get("chunk", sharding.renderer.DEFAULT_CHUNK),
            rng_mode=kwargs.get("rng_mode", "fixed"),
            stratify=kwargs.get("stratify", False),
        )
        fb_np = np.asarray(multihost_utils.process_allgather(fb, tiled=True))
        ms = (time.perf_counter() - t0) * 1e3
        if jax.process_index() == 0:
            print(f"{n}\t{ms}\t{rays}", file=out)
            try:
                filename = params.output_path % n
            except TypeError:
                filename = params.output_path
            writer(filename, fb_np, divisor)
    return fb_np
