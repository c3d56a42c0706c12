"""Primitive-count scaling curve: brute force against the BVH, on the GPU.

Settles the >2K-primitive acceleration-structure question with data
(reference analog: the BVH `include/bvh.h:19-65` is the reference's
core scaling device; ours must either win somewhere or have its ceiling
written down). Scenes are non-overlapping sphere grids at N in
{2000, 5000, 10000, 20000}, rendered at 800x600.

Intersectors (tracer.render.integrator):
  fast - dense [rays x primitives] brute force (the default)
  bvh  - batched short-stack BVH traversal

Usage:
  python benchmarks/prim_scaling.py                  # full sweep, TSV
  python benchmarks/prim_scaling.py --ns 2000,5000 --intersectors fast
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WIDTH, HEIGHT, SPP, DEPTH = 800, 600, 4, 10


def build_field(n):
    """Non-overlapping sphere field + floor quad (same construction as
    bench.py's config-5 scene, scaled to n)."""
    import numpy as np

    from tracer.scene import types as T

    g = np.random.default_rng(3)
    cols = int(np.ceil(np.sqrt(n * 1.25)))
    rows = int(np.ceil(n / cols))
    radii = g.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    cell = np.stack(
        [gx.ravel() * 2.0 - (cols - 1.0), gy.ravel() * 2.0 - (rows - 1.0)], -1
    )[:n]
    slack = (1.0 - radii - 0.02)[:, None]
    centers = np.zeros((n, 3), np.float32)
    centers[:, :2] = cell + g.uniform(-1, 1, size=(n, 2)) * slack
    centers[:, 2] = radii + 0.05 + g.uniform(0, 6, size=(n,))
    half = float(cols + 10)
    mats = T.make_materials(
        mtype=np.array([T.LAMBERTIAN, T.METAL, T.DIFFUSE_LIGHT], np.int32),
        fuzz=np.array([0, 0.2, 0], np.float32),
        ir=np.ones(3, np.float32),
        absorption=np.zeros((3, 3), np.float32),
        albedo=np.array(
            [[0.7, 0.5, 0.4], [0.8, 0.8, 0.9], [0, 0, 0]], np.float32
        ),
        emit=np.array([[0, 0, 0], [0, 0, 0], [9, 8, 7]], np.float32),
        tex_id=np.full(3, -1, np.int32),
    )
    scene = T.Scene(
        spheres=T.make_spheres(
            centers, radii, (np.arange(n) % 3).astype(np.int32)
        ),
        planes=T.make_planes(
            np.array([T.QUAD], np.int32),
            np.array([[-half, -half, 0]], np.float32),
            np.array([[2 * half, 0, 0]], np.float32),
            np.array([[0, 2 * half, 0]], np.float32),
            np.array([0], np.int32),
        ),
        materials=mats,
        textures=None,
        bvh=None,
    )
    return scene, cols


def cam_for(cols):
    from tracer.render import camera as camera_mod

    d = cols * 1.6
    return camera_mod.build_camera_data(
        origin=[d, 0.0, d * 0.45], look_at=[0.0, 0.0, 3.0],
        width=WIDTH, height=HEIGHT, vfov=55.0,
    )


def measure_cell(intersector, n, rr_start):
    import jax
    import numpy as np

    from tracer.render import renderer

    scene, cols = build_field(n)
    cam = cam_for(cols)
    if intersector == "bvh":
        from tracer.bvh import builder as bvh_builder

        scene = scene._replace(bvh=bvh_builder.build_bvh_arrays(
            np.asarray(scene.spheres.center), np.asarray(scene.spheres.radius),
            np.asarray(scene.planes.base), np.asarray(scene.planes.u),
            np.asarray(scene.planes.v), np.asarray(scene.planes.ptype),
        ))

    def run():
        return jax.block_until_ready(renderer.render_frame(
            scene, cam, WIDTH, HEIGHT, spp=SPP, max_depth=DEPTH,
            intersector=intersector, early_exit=True, rr_start=rr_start,
        ))

    run()  # compile
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return min(times)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ns", default="2000,5000,10000,20000")
    ap.add_argument("--intersectors", default="fast,bvh")
    ap.add_argument("--rr", type=int, default=3, help="rr_start bounce (-1 = off)")
    args = ap.parse_args()
    rr = None if args.rr < 0 else args.rr

    import jax

    from tracer.utils import compile_cache, profiling

    if jax.devices()[0].platform != "gpu":
        print("prim_scaling: JAX found no GPU", file=sys.stderr)
        return 2
    compile_cache.enable()
    print(profiling.nvidia_smi_line(), flush=True)
    print("intersector\tn\tseconds\tMrays/s", flush=True)
    for n in (int(x) for x in args.ns.split(",") if x):
        for intersector in (e for e in args.intersectors.split(",") if e):
            best = measure_cell(intersector, n, rr)
            print(f"{intersector}\t{n}\t{best:.3f}\t"
                  f"{WIDTH * HEIGHT * SPP / best / 1e6:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
