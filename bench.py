"""Benchmark matrix on one NVIDIA GPU: forward and forward+backward
throughput of the XLA renderer on the BASELINE configs.

    python bench.py

Prints one JSON line per cell:

  {"metric": "fwd_mrays_per_s", "value": N, "unit": "Mrays/s", "shape": ...,
   "seconds": [...], "compile_s": ..., "peak_bytes_in_use": ...,
   "platform": "gpu", "device_kind": ..., "device_count": 1,
   "card": ..., "power_limit_w": ...}

Mrays/s counts primary rays (W*H*spp per frame, the reference's TSV
convention, camera.cu:344-345). Each cell compiles first (compile_s) and
then times whole frames or gradient steps that end in
`jax.block_until_ready`; `value` uses the fastest. The four heaviest
cells time fewer samples than their config names (`reduced`, e.g. "spp 8
of 64"): every sample is the same work, so the rate does not depend on
spp once a step is large (measured: config 5 at 64 and 256 spp gave the
same rate), and at full spp those cells alone take over an hour on one
H100. The floor texture is a seeded synthetic 2000x1330 image, the
reference floor's size. A cell that fails prints its error and the
script exits nonzero; without a GPU it exits before measuring anything.
peak_bytes_in_use is the process's peak so far, not the cell's own.
"""

from __future__ import annotations

import io
import json
import sys
import time
import traceback

import numpy as np

WIDTH, HEIGHT, SPP, DEPTH = 800, 600, 32, 50


def floor_texture():
    return np.random.default_rng(0).uniform(0.1, 1.0, (1330, 2000, 3)).astype(np.float32)


def sphere_field(n, cols, rows, seed, half, z_range, mtypes, fuzz, albedo, tex_id,
                 mat_of):
    """Non-overlapping sphere grid (jitter bounded by the radius
    clearance) over a floor quad, as in BASELINE configs 4 and 5."""
    from tracer.scene import types as T

    g = np.random.default_rng(seed)
    radii = g.uniform(0.3, 0.95, size=(n,)).astype(np.float32)
    gx, gy = np.meshgrid(np.arange(cols), np.arange(rows), indexing="ij")
    cell = np.stack([gx.ravel() * 2.0 - (cols - 1.0), gy.ravel() * 2.0 - (rows - 1.0)], -1)
    centers = np.zeros((n, 3), np.float32)
    centers[:, :2] = cell + g.uniform(-1, 1, size=(n, 2)) * (1.0 - radii - 0.02)[:, None]
    centers[:, 2] = radii + 0.05 + g.uniform(0, z_range, size=(n,))
    mats = T.make_materials(
        mtype=np.array(mtypes, np.int32),
        fuzz=np.array(fuzz, np.float32),
        ir=np.ones(3, np.float32),
        absorption=np.zeros((3, 3), np.float32),
        albedo=np.array(albedo, np.float32),
        emit=np.array([[0, 0, 0], [0, 0, 0], [9, 8, 7]], np.float32),
        tex_id=np.array(tex_id, np.int32),
    )
    return T.Scene(
        spheres=T.make_spheres(centers, radii, mat_of(np.arange(n)).astype(np.int32)),
        planes=T.make_planes(
            np.array([T.QUAD], np.int32), np.array([[-half, -half, 0]], np.float32),
            np.array([[2 * half, 0, 0]], np.float32), np.array([[0, 2 * half, 0]], np.float32),
            np.array([0], np.int32)),
        materials=mats, textures=None, bvh=None,
    )


def build_cells():
    """[(metric, fn(scene, cam), scene, [cams], rays per call, extra)]."""
    import jax
    import jax.numpy as jnp

    from tracer.dist import sharding
    from tracer.render import camera as camera_mod
    from tracer.render import renderer
    from tracer.scene import builders, config
    from tracer.scene import types as T

    params = config.read_scene_params(io.StringIO(config.default_config_text()))
    canon_tex = builders.create_scene(params, texture_loader=lambda _: floor_texture())
    canon = canon_tex._replace(textures=None)

    def cams(w, h, frames=(1, 2, 3)):
        return [camera_mod.camera_at(params.camera_path, k, params.num_frames, w, h,
                                     params.fov_degrees) for k in frames]

    def forward(w, h, spp, depth, **kw):
        return jax.jit(lambda scene, cam: renderer.render_frame(
            scene, cam, w, h, spp, depth, early_exit=True, **kw))

    def l2_grad(w, h, spp, depth, freeze_texture=False, **kw):
        """jax.grad of mean((fb/spp)^2) w.r.t. scene and camera."""
        def loss(scene, cam):
            if freeze_texture:
                scene = scene._replace(textures=jax.lax.stop_gradient(scene.textures))
            fb = renderer.render_frame(scene, cam, w, h, spp, depth, **kw)
            return jnp.mean((fb / spp) ** 2)
        return jax.jit(jax.grad(loss, argnums=(0, 1), allow_int=True))

    cells = []

    def cell(metric, fn, scene, cam_list, w, h, spp, depth, config_spp=None, **extra):
        """`spp` is what fn traces; `config_spp` the config's, when cut."""
        shape = f"{w}x{h}x{spp}spp d{depth}"
        if config_spp:
            extra["reduced"] = f"spp {spp} of {config_spp}"
        cells.append((metric, fn, scene, cam_list, w * h * spp, dict(shape=shape, **extra)))

    W, H = WIDTH, HEIGHT
    # 1-3. canonical config.txt scene (BASELINE config 3) at 800x600 32 spp
    cell("fwd_mrays_per_s", forward(W, H, SPP, DEPTH), canon_tex, cams(W, H),
         W, H, SPP, DEPTH, textured=True)
    cell("fwd_untextured_mrays_per_s", forward(W, H, SPP, DEPTH), canon, cams(W, H),
         W, H, SPP, DEPTH)
    cell("fwd_rr_mrays_per_s", forward(W, H, SPP, DEPTH, rr_start=3), canon, cams(W, H),
         W, H, SPP, DEPTH, rr_start=3)
    # 4. the reference's literal workload: one config.txt frame as written
    #    (2500 spp; 538 s per frame at full spp on one H100, PERF.md)
    cw, ch = params.width, params.height
    cspp, cdepth = params.render.sqrt_rays_per_pixel ** 2, params.render.max_depth
    cell("fwd_canonical_aswritten_mrays_per_s", forward(cw, ch, 100, cdepth),
         canon_tex, cams(cw, ch, frames=(1,)), cw, ch, 100, cdepth, config_spp=cspp,
         textured=True)
    # 5-6. forward+backward, 800x600 32 spp depth 8
    gw, gh, gspp, gdepth = 800, 600, 32, 8
    cell("fwdbwd_mrays_per_s", l2_grad(gw, gh, gspp, gdepth), canon, cams(gw, gh),
         gw, gh, gspp, gdepth)
    cell("fwdbwd_rr_mrays_per_s", l2_grad(gw, gh, gspp, gdepth, rr_start=3), canon,
         cams(gw, gh), gw, gh, gspp, gdepth, rr_start=3)
    # 7. forward+backward at the reference's real depth (config.txt:16)
    dw, dh, dspp, ddepth = 1080, 720, 8, 50
    cell("fwdbwd_d50_mrays_per_s", l2_grad(dw, dh, dspp, ddepth), canon,
         cams(dw, dh, frames=(1, 2)), dw, dh, dspp, ddepth, config_spp=64)
    # 8-9. 2000-sphere field (BASELINE config 5 scale), forward
    big = sphere_field(2000, 50, 40, 3, 60.0, 6.0,
                       [T.LAMBERTIAN, T.METAL, T.DIFFUSE_LIGHT], [0, 0.2, 0],
                       [[0.7, 0.5, 0.4], [0.8, 0.8, 0.9], [0, 0, 0]], [-1, -1, -1],
                       lambda i: i % 3)
    bspp, bdepth = 8, 20
    cell("fwd_2000sph_mrays_per_s", forward(W, H, bspp, bdepth), big, cams(W, H),
         W, H, bspp, bdepth, spheres=2000)
    cell("fwd_2000sph_rr_mrays_per_s", forward(W, H, bspp, bdepth, rr_start=3), big,
         cams(W, H), W, H, bspp, bdepth, spheres=2000, rr_start=3)
    # 10-11. BASELINE config 4: textured floor + 500-sphere field, 1080x720
    #     64 spp, forward+backward; the texture image held constant (10)
    #     and differentiated too (11, a scatter-add into 2000x1330x3)
    cfg4 = sphere_field(500, 25, 20, 11, 40.0, 5.0,
                        [T.METAL, T.LAMBERTIAN, T.DIFFUSE_LIGHT], [0.1, 0, 0],
                        [[0.9, 0.9, 0.9], [0.6, 0.4, 0.3], [0, 0, 0]], [0, -1, -1],
                        lambda i: 1 + i % 2)
    cfg4 = cfg4._replace(textures=jnp.asarray(floor_texture())[None])
    c4w, c4h, c4spp, c4depth = 1080, 720, 16, 8
    cfg4_cams = [camera_mod.build_camera_data(
        origin=[55 * np.cos(0.08 * k), 55 * np.sin(0.08 * k), 22], look_at=[0, 0, 2],
        width=c4w, height=c4h, vfov=50.0) for k in (1, 2)]
    cell("fwdbwd_textured_mrays_per_s",
         l2_grad(c4w, c4h, c4spp, c4depth, freeze_texture=True), cfg4, cfg4_cams,
         c4w, c4h, c4spp, c4depth, config_spp=64, spheres=500, texture_grads=False)
    cell("fwdbwd_texgrad_mrays_per_s", l2_grad(c4w, c4h, c4spp, c4depth), cfg4,
         cfg4_cams, c4w, c4h, c4spp, c4depth, config_spp=64, spheres=500,
         texture_grads=True)
    # 12. BASELINE config 5: 2K spheres, 4K frame, tiles sharded (a 1-device
    #     mesh here), grads on all scene params through the spp-chunked
    #     sharded VJP (sharding.l2_grads_deep_sharded)
    c5w, c5h, c5spp, c5depth = 3840, 2160, 2, 8
    mesh1 = sharding.make_mesh(jax.devices()[:1])
    c5cam = camera_mod.build_camera_data(origin=[80, 0, 35], look_at=[0, 0, 3],
                                         width=c5w, height=c5h, vfov=55.0)

    @jax.jit
    def cfg5_step(scene, cam):
        target = jnp.zeros((c5h, c5w, 3), jnp.float32)
        return sharding.l2_grads_deep_sharded(scene, cam, target, c5w, c5h, c5spp,
                                              c5depth, mesh1)

    cell("fwdbwd_cfg5_mrays_per_s", cfg5_step, big, [c5cam], c5w, c5h, c5spp, c5depth,
         config_spp=256, spheres=2000,
         method="l2_grads_deep_sharded on a 1-device mesh")
    return cells


def measure(fn, scene, cam_list):
    """(compile seconds, [seconds per timed call]) for a jitted fn: it is
    compiled ahead of time, then called once per camera."""
    import jax

    t0 = time.perf_counter()
    compiled = fn.lower(scene, cam_list[0]).compile()
    compile_s = time.perf_counter() - t0
    times = []
    for cam in cam_list:
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(scene, cam))
        times.append(time.perf_counter() - t0)
    return compile_s, times


def main() -> int:
    import jax

    from tracer.utils import compile_cache, profiling

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: JAX found no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    compile_cache.enable()
    card, power_w = profiling.parse_smi(profiling.nvidia_smi_line())
    device = dict(platform=devices[0].platform, device_kind=devices[0].device_kind,
                  device_count=len(devices), card=card, power_limit_w=power_w)
    failed = []
    for metric, fn, scene, cam_list, rays, extra in build_cells():
        try:
            compile_s, times = measure(fn, scene, cam_list)
        except Exception:  # reported; the script exits nonzero
            traceback.print_exc()
            print(f"bench: cell {metric} failed", file=sys.stderr, flush=True)
            failed.append(metric)
            continue
        stats = devices[0].memory_stats() or {}
        rec = dict(metric=metric, value=rays / min(times) / 1e6, unit="Mrays/s",
                   engine="xla", **extra, seconds=times, compile_s=compile_s,
                   peak_bytes_in_use=stats.get("peak_bytes_in_use"), **device)
        print(json.dumps(rec), flush=True)
    if failed:
        print(f"bench: failed cells: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
