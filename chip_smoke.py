"""Smoke test of tracer on an NVIDIA GPU: the quickest proof that the
system starts, renders, agrees with its references and fits on the card.

    python3 chip_smoke.py            # one GPU: phases 1-5 below
    python3 chip_smoke.py --four     # four GPUs: the sharded path only

Phases (one GPU), in order; a phase whose input failed is skipped and
counts as failed:

1. device: JAX must report a GPU; prints the card's name and power
   limit (nvidia-smi), the JAX and CUDA versions and the compile cache.
2. cli_render: `tracer.cli.main(["--gpu", ...])` on the canonical
   config (1080x720, depth 50, 3 bodies, 4 lights) with the floor
   texture a 2000x1330 PPM made from --seed, capped to 2 frames and
   sqrt_spp 4 (the config says 50); checks the TSV and both frames.
3. parity: at 1080x720, the `fast` intersector against `brute` (the
   readable reference port); at 64x48 (the smoke config), the GPU
   against the CPU backend with both RNG modes.
4. fit: a 3-step inverse-rendering fit through the CLI at 1080x720 and
   depth 50 (sqrt_spp 1) from perturbed body colours towards phase 2's
   frame 0; then jax.grad against central differences on the card.
5. deep_grad: tracer.opt.grads.l2_grads_deep at 1080x720, 4 spp, depth
   50, in spp chunks against one chunk; prints peak device memory.

With --four only the sharded path runs, on a 1-D mesh of four GPUs:
render_frame_sharded, scene_grads_sharded and l2_grads_deep_sharded
against their single-device forms.

The last line of stdout is {"ok": true, "device": {...}} when every
phase passed. Any failure, or no GPU, exits nonzero without it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import sys
import tempfile
import time
import traceback

import numpy as np

# The canonical config (tracer.scene.config.default_config_text) and the
# cuts this smoke run makes to it.
WIDTH, HEIGHT, DEPTH = 1080, 720, 50
TEX_H, TEX_W = 1330, 2000  # the reference floor texture's size
CLI_FRAMES, CLI_SQRT_SPP = 2, 4  # config: 100 frames, sqrt_spp 50
PARITY_SPP = 2
SMALL_W, SMALL_H = 64, 48
FIT_STEPS, FIT_SQRT_SPP, FIT_LR = 3, 1, 0.05
DEEP_SPP, DEEP_CHUNK = 4, 2
FOUR_SPP, FOUR_GRAD_SPP, FOUR_GRAD_DEPTH = 4, 2, 8

# Parity tolerances. Libdevice transcendentals (sqrt, atan2, acos, ...)
# differ from the CPU's by ulps, and an ulp can flip a silhouette hit or
# an RNG gate, which changes that pixel completely. So a share of pixels
# must agree within a relative tolerance, and the image mean tightly;
# pixel-exact equality is not expected.
PIXEL_RTOL, PIXEL_ATOL = 1e-4, 1e-6
PIXEL_SHARE = 0.995
MEAN_RTOL = 1e-3
# `fast` and `brute` are two formulations of the roots (projection
# matmuls vs per-primitive dot products), so they differ by ulps on every
# bounce, not only on a gate flip; 50 bounces spread that to more pixels
# (99.46-99.74% within 1e-4 on the CPU at 96x64 and 216x144).
FAST_BRUTE_SHARE = 0.99
# Gradients: the same f32 sums taken in another order (chunks, devices,
# atomics), relative to each leaf's largest magnitude.
GRAD_RTOL = 1e-4
# Finite differences (as tests/test_grad.py): central step h, f32 loss.
FD_RTOL, FD_ATOL = 0.08, 5e-4


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="tracer smoke test on the GPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic floor texture and targets")
    p.add_argument("--four", action="store_true",
                   help="run only the sharded path on four GPUs")
    return p.parse_args(argv)


def phase_names(four: bool):
    return ["device", "four"] if four else [
        "device", "cli_render", "parity", "fit", "deep_grad"]


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def frames_agree(got, want):
    """(share of pixels within PIXEL_RTOL, |mean rel err|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    close = (np.abs(got - want) <= PIXEL_RTOL * np.abs(want) + PIXEL_ATOL).all(-1)
    mean_err = abs(got.mean() - want.mean()) / max(abs(want.mean()), 1e-12)
    return float(close.mean()), float(mean_err)


def check_frames(name, got, want, need_share=PIXEL_SHARE):
    share, mean_err = frames_agree(got, want)
    print(f"  {name}: {share:.5%} of pixels within rel {PIXEL_RTOL:g} "
          f"(need {need_share:.1%}), mean rel err {mean_err:.3g} "
          f"(need <= {MEAN_RTOL:g})", flush=True)
    if share < need_share or mean_err > MEAN_RTOL:
        raise AssertionError(f"{name}: frames disagree")


def check_grads(name, got, want):
    import jax

    worst = 0.0
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        if a.dtype == jax.dtypes.float0:
            continue
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"{name}: non-finite gradient")
        scale = np.abs(b).max()
        if scale > 0:
            worst = max(worst, float(np.abs(a - b).max() / scale))
    print(f"  {name}: max leaf error {worst:.3g} of the leaf's largest "
          f"magnitude (need <= {GRAD_RTOL:g})", flush=True)
    if worst > GRAD_RTOL:
        raise AssertionError(f"{name}: gradients disagree")


class Run:
    """Shared state of one smoke run: temp dir, configs, scene."""

    def __init__(self, work: str, seed: int):
        self.work = work
        self.seed = seed
        self.frame0 = None  # phase 2's frame 0 (bin path)
        self.make_texture()

    def config_text(self, sqrt_spp: int, body_colours=None) -> str:
        from tracer.scene import config

        lines = config.default_config_text().splitlines()
        lines[1] = os.path.join(self.work, "render_%d.bin")
        lines = [l.replace("floor.jpg", self.texture_path) for l in lines]
        if body_colours:
            for k, col in enumerate(body_colours):
                t = lines[5 + k].split()
                t[3:6] = [str(c) for c in col]
                lines[5 + k] = " ".join(t)
        depth, _ = lines[-1].split()
        lines[-1] = f"{depth} {sqrt_spp}"
        return "\n".join(lines) + "\n"

    def write_config(self, name: str, text: str) -> str:
        path = os.path.join(self.work, name)
        with open(path, "w") as f:
            f.write(text)
        return path

    @property
    def texture_path(self) -> str:
        return os.path.join(self.work, "floor.ppm")

    def make_texture(self):
        from tracer.io import image as image_io

        g = np.random.default_rng(self.seed)
        image_io.write_ppm_binary(
            self.texture_path, g.integers(0, 256, (TEX_H, TEX_W, 3), np.uint8))

    def scene_and_params(self, sqrt_spp: int):
        from tracer.scene import builders, config

        params = config.read_scene_params(self.config_text(sqrt_spp))
        return builders.create_scene(params), params

    def camera(self, params, width, height, frame=0):
        from tracer.render import camera as camera_mod

        return camera_mod.camera_at(params.camera_path, frame, CLI_FRAMES,
                                    width, height, params.fov_degrees)


def run_cli(argv):
    """tracer.cli.main in this process; returns (rc, stdout text)."""
    from tracer import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def phase_cli_render(run: Run):
    from tracer.io import image as image_io

    scene, _ = run.scene_and_params(CLI_SQRT_SPP)
    if scene.textures is None or scene.textures.shape != (1, TEX_H, TEX_W, 3):
        raise AssertionError("the floor texture did not load")
    cfg = run.write_config("render.cfg", run.config_text(CLI_SQRT_SPP))
    print(f"  cut: {CLI_FRAMES} of 100 frames, sqrt_spp {CLI_SQRT_SPP} of 50 "
          f"({CLI_SQRT_SPP ** 2} spp); {WIDTH}x{HEIGHT}, depth {DEPTH}, "
          f"floor texture {TEX_W}x{TEX_H}", flush=True)
    rc, out = run_cli(["--gpu", "--config", cfg, "--frames", str(CLI_FRAMES),
                       "--no-saver-quirk"])
    if rc != 0:
        raise AssertionError(f"tracer.cli exited {rc}")
    rows = [l.split("\t") for l in out.splitlines() if l.count("\t") == 2]
    if [int(r[0]) for r in rows] != list(range(CLI_FRAMES)):
        raise AssertionError(f"bad TSV: {out!r}")
    for n, ms, rays in rows:
        if int(rays) != WIDTH * HEIGHT * CLI_SQRT_SPP ** 2 or not float(ms) > 0:
            raise AssertionError(f"bad TSV row {n, ms, rays}")
        print(f"  frame {n}: {float(ms):.1f} ms, {int(rays)} rays "
              f"({int(rays) / float(ms) / 1e3:.1f} Mrays/s, first frame "
              "includes compilation)", flush=True)
    for n in range(CLI_FRAMES):
        path = os.path.join(run.work, f"render_{n}.bin")
        im = image_io.read_binary(path)
        lit = float((im.max(-1) > 0).mean())
        print(f"  {os.path.basename(path)}: {im.shape[1]}x{im.shape[0]}, mean "
              f"byte {im.mean():.2f}, {lit:.1%} of pixels lit", flush=True)
        if im.shape != (HEIGHT, WIDTH, 3) or im.mean() < 1.0 or lit < 0.01:
            raise AssertionError(f"{path}: black or misshapen frame")
    run.frame0 = os.path.join(run.work, "render_0.bin")


def phase_parity(run: Run):
    import jax

    from tracer.render import renderer
    from tracer.scene import builders, config

    scene, params = run.scene_and_params(1)
    cam = run.camera(params, WIDTH, HEIGHT)
    with jax.default_matmul_precision("highest"):
        fast = renderer.render_frame(scene, cam, WIDTH, HEIGHT, PARITY_SPP, DEPTH,
                                     intersector="fast")
        brute = renderer.render_frame(scene, cam, WIDTH, HEIGHT, PARITY_SPP, DEPTH,
                                      intersector="brute")
        check_frames(f"fast vs brute, {WIDTH}x{HEIGHT} {PARITY_SPP} spp d{DEPTH}",
                     fast, brute, FAST_BRUTE_SHARE)

        small = config.read_scene_params(config.smoke_config_text())
        small_scene = builders.create_scene(
            small, texture_loader=lambda _: np.asarray(scene.textures[0]))
        small_cam = run.camera(small, SMALL_W, SMALL_H)
        spp = small.render.sqrt_rays_per_pixel ** 2
        gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
        for rng_mode in ("fixed", "reference"):
            frames = []
            for dev in (gpu, cpu):
                s, c = jax.device_put((small_scene, small_cam), dev)
                frames.append(np.asarray(renderer.render_frame(
                    s, c, SMALL_W, SMALL_H, spp, small.render.max_depth,
                    rng_mode=rng_mode)))
            check_frames(f"GPU vs CPU, {SMALL_W}x{SMALL_H} rng {rng_mode}", *frames)


def _fd_scene():
    """A small textured scene under a bright sky, as in tests/test_grad.py."""
    import jax.numpy as jnp

    from tracer.scene import types as T

    g = np.random.default_rng(5)
    spheres = T.make_spheres(
        [[0.0, 0.0, 1.0], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0], [0.0, 2.5, 4.0]],
        [1.0, 1.0, 1.0, 1.0], [0, 1, 2, 3])
    planes = T.make_planes([T.QUAD], [[-8, -8, 0]], [[16, 0, 0]], [[0, 16, 0]], [4])
    mats = T.make_materials(
        mtype=[T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.LAMBERTIAN],
        fuzz=[0.0, 0.25, 0.0, 0.0, 0.0], ir=[1.0, 1.0, 1.5, 1.0, 1.0],
        absorption=[[0, 0, 0], [0, 0, 0], [0.3, 0.5, 0.1], [0, 0, 0], [0, 0, 0]],
        albedo=[[0.7, 0.3, 0.3], [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.5, 0.5, 0.5]],
        emit=[[0, 0, 0], [0, 0, 0], [0, 0, 0], [6, 5, 4], [0, 0, 0]],
        tex_id=[0, -1, -1, -1, -1])
    tex = jnp.asarray(g.uniform(0.2, 1.0, size=(1, 40, 56, 3)).astype(np.float32))
    return T.Scene(spheres, planes, mats, tex, None)


def fd_check():
    """jax.grad against central differences for materials.albedo,
    spheres.center and camera.origin, on the card at "highest" precision."""
    import jax
    import jax.numpy as jnp

    from tracer.render import camera as camera_mod
    from tracer.render import renderer

    # the size of tests/test_grad.py, where no silhouette or gate crosses
    # a sample within +-h at these parameters
    w, h, spp, depth = 12, 8, 2, 4
    scene = _fd_scene()

    def cam_at(x):
        return camera_mod.build_camera_data(
            jnp.stack([x, jnp.float32(-6.0), jnp.float32(3.0)]), [0.0, 0.0, 1.0],
            w, h, 55.0, background=(0.8, 0.9, 1.0))

    def with_leaf(group, field, idx):
        def set_v(v):
            sub = getattr(scene, group)
            arr = getattr(sub, field).at[idx].set(v)
            return scene._replace(**{group: sub._replace(**{field: arr})}), cam_at(5.0)
        return set_v

    probes = {
        "materials.albedo": (0.7, with_leaf("materials", "albedo", (0, 0)), 1e-3),
        "spheres.center": (1.0, with_leaf("spheres", "center", (0, 2)), 2e-3),
        "camera.origin": (5.0, lambda v: (scene, cam_at(v)), 2e-3),
    }
    with jax.default_matmul_precision("highest"):
        for name, (v0, set_v, step) in probes.items():
            def loss_of(v):
                s, c = set_v(v)
                fb = renderer.render_frame(s, c, w, h, spp, depth)
                return jnp.sum(fb * fb) / (w * h * spp)

            v0 = jnp.float32(v0)
            g_ad = float(jax.grad(loss_of)(v0))
            g_fd = float((loss_of(v0 + step) - loss_of(v0 - step)) / (2 * step))
            print(f"  d loss / d {name}: AD {g_ad:.6g}, central difference "
                  f"{g_fd:.6g} (h {step:g})", flush=True)
            if abs(g_fd) <= 5 * FD_ATOL or abs(g_ad - g_fd) > FD_RTOL * abs(g_fd) + FD_ATOL:
                raise AssertionError(f"{name}: AD and finite differences disagree")


def phase_fit(run: Run):
    if run.frame0 is None:
        raise AssertionError("needs phase cli_render's frame 0")
    colours = [(0.6, 0.2, 0.1), (0.1, 0.5, 0.2), (0.2, 0.1, 0.6)]  # config: 0.3 on one channel
    cfg = run.write_config("fit.cfg", run.config_text(FIT_SQRT_SPP, colours))
    print(f"  fit: {FIT_STEPS} steps of materials.albedo at {WIDTH}x{HEIGHT}, "
          f"depth {DEPTH}, sqrt_spp {FIT_SQRT_SPP}, lr {FIT_LR}", flush=True)
    rc, out = run_cli(["--gpu", "--config", cfg, "--fit", run.frame0,
                       "--fit-params", "materials.albedo",
                       "--fit-steps", str(FIT_STEPS), "--fit-lr", str(FIT_LR),
                       "--no-saver-quirk"])
    if rc != 0:
        raise AssertionError(f"tracer.cli --fit exited {rc}")
    first = re.search(r"^step 0\tloss (\S+)$", out, re.M)
    final = re.search(r"^final loss: (\S+)$", out, re.M)
    if not (first and final):
        raise AssertionError(f"no losses in the fit output: {out!r}")
    l0, l_end = float(first.group(1)), float(final.group(1))
    print(f"  loss: step 0 {l0:.6g}, step {FIT_STEPS - 1} {l_end:.6g}", flush=True)
    if not (math.isfinite(l0) and math.isfinite(l_end) and l_end < l0):
        raise AssertionError("the fit loss is not finite and falling")
    fd_check()


def phase_deep_grad(run: Run):
    import jax

    from tracer.opt import grads

    scene, params = run.scene_and_params(1)
    cam = run.camera(params, WIDTH, HEIGHT)
    target = np.full((HEIGHT, WIDTH, 3), 0.05, np.float32)
    out = {}
    for chunk in (None, DEEP_CHUNK):
        t0 = time.perf_counter()
        loss, gs, gc = jax.block_until_ready(grads.l2_grads_deep(
            scene, cam, target, WIDTH, HEIGHT, DEEP_SPP, DEPTH, spp_chunk=chunk))
        print(f"  l2_grads_deep {WIDTH}x{HEIGHT} {DEEP_SPP} spp d{DEPTH} "
              f"spp_chunk={chunk}: loss {float(loss):.6g}, "
              f"{time.perf_counter() - t0:.1f} s incl. compile", flush=True)
        out[chunk] = (loss, gs, gc)
    if not math.isclose(float(out[None][0]), float(out[DEEP_CHUNK][0]), rel_tol=1e-6):
        raise AssertionError("the chunked loss differs")
    check_grads(f"spp_chunk={DEEP_CHUNK} vs one chunk", out[DEEP_CHUNK][1:], out[None][1:])
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}", flush=True)


def phase_four(run: Run):
    import jax

    from tracer.dist import sharding
    from tracer.opt import grads
    from tracer.render import renderer

    devices = jax.devices()[:4]
    if len(devices) != 4:
        raise AssertionError(f"--four needs 4 GPUs, JAX sees {len(jax.devices())}")
    mesh = sharding.make_mesh(devices)
    scene, params = run.scene_and_params(1)
    cam = run.camera(params, WIDTH, HEIGHT)

    single = renderer.render_frame(scene, cam, WIDTH, HEIGHT, FOUR_SPP, DEPTH)
    sharded = sharding.render_frame_sharded(scene, cam, WIDTH, HEIGHT, FOUR_SPP,
                                            DEPTH, mesh)
    for shard in sharded.addressable_shards:
        rows = shard.index[0]
        print(f"  rows {rows.start}:{rows.stop} on {shard.device}", flush=True)
    check_frames(f"render_frame_sharded vs render_frame, {WIDTH}x{HEIGHT} "
                 f"{FOUR_SPP} spp d{DEPTH}", sharded, single)

    target = np.full((HEIGHT, WIDTH, 3), 0.05, np.float32)
    spp, depth = FOUR_GRAD_SPP, FOUR_GRAD_DEPTH

    def loss_single(scene):
        fb = renderer.render_frame(scene, cam, WIDTH, HEIGHT, spp, depth)
        return ((fb / spp - target) ** 2).mean()

    l1, g1 = jax.value_and_grad(loss_single, allow_int=True)(scene)
    l4, g4 = sharding.scene_grads_sharded(scene, cam, target, WIDTH, HEIGHT, spp,
                                          depth, mesh)
    print(f"  scene_grads_sharded loss {float(l4):.6g}, jax.grad {float(l1):.6g}")
    check_grads(f"scene_grads_sharded vs jax.grad, {spp} spp d{depth}", g4, g1)

    ref = grads.l2_grads_deep(scene, cam, target, WIDTH, HEIGHT, spp, depth,
                              spp_chunk=1)
    got = sharding.l2_grads_deep_sharded(scene, cam, target, WIDTH, HEIGHT, spp,
                                         depth, mesh, spp_chunk=1)
    print(f"  l2_grads_deep_sharded loss {float(got[0]):.6g}, "
          f"l2_grads_deep {float(ref[0]):.6g}")
    check_grads("l2_grads_deep_sharded vs l2_grads_deep", got[1:], ref[1:])


PHASES = {
    "cli_render": phase_cli_render,
    "parity": phase_parity,
    "fit": phase_fit,
    "deep_grad": phase_deep_grad,
    "four": phase_four,
}


def check_device():
    """Phase 1. Returns the devices, or None when JAX finds no GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return None
    from tracer.utils import compile_cache, profiling

    print(profiling.nvidia_smi_line(), flush=True)
    print(f"jax {jax.__version__}, {devices[0].client.platform_version}, "
          f"{len(devices)} x {devices[0].device_kind}; compile cache "
          f"{compile_cache.enable()}", flush=True)
    return devices


def main(argv=None) -> int:
    args = parse_args(argv)
    devices = check_device()
    if devices is None:
        return 2
    failed = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if re.search(r"\s", work):
            raise SystemExit(f"temp dir {work!r} has whitespace; set TMPDIR")
        run = Run(work, args.seed)
        for name in phase_names(args.four)[1:]:
            print(f"== {name}", flush=True)
            t0 = time.perf_counter()
            try:
                PHASES[name](run)
            except Exception:  # reported, and the run exits nonzero
                traceback.print_exc()
                failed.append(name)
                print(f"== {name} FAILED", flush=True)
            else:
                print(f"== {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
