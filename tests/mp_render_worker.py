"""Worker for the 2-process multihost test (run via subprocess).

Usage: python mp_render_worker.py <process_id> <port> <outdir>

Renders the shrunken smoke scene through
tracer.dist.multihost.render_animation_multihost(frame_shard=False) on a
GLOBAL 4-device CPU mesh spanning 2 processes (2 local devices each),
exercising the process_allgather + process-0-writes branch
(multihost.py) that single-process tests cannot reach.
"""

import io
import os
import sys

# run as a script, sys.path[0] is tests/ — make `import tracer` work
# regardless of how the parent pytest was invoked
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "-1")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.0")

import jax

from tracer.utils import compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
compile_cache.enable()


def main() -> int:
    pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from tracer.dist import multihost

    multihost.initialize(
        coordinator_address=f"localhost:{port}", num_processes=2, process_id=pid
    )
    assert jax.device_count() == 4 and jax.local_device_count() == 2

    from tracer.scene import builders, config

    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    params.width, params.height = 16, 8
    params.num_frames = 2
    params.render.sqrt_rays_per_pixel = 1
    params.render.max_depth = 2
    params.output_path = os.path.join(outdir, "mh_%d.bin")
    scene = builders.create_scene(params, texture_loader=lambda _: None)

    tsv = io.StringIO()
    multihost.render_animation_multihost(
        scene, params, frame_shard=False, out=tsv, stratify=False,
        rng_mode="fixed",
    )
    # the TSV timing lines must come only from process 0
    with open(os.path.join(outdir, f"tsv_{pid}.txt"), "w") as f:
        f.write(tsv.getvalue())
    return 0


if __name__ == "__main__":
    sys.exit(main())
