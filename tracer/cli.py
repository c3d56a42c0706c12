"""Command-line driver.

Covers the reference CLI (src/main.cu:572-606): no args / `--gpu` render
from a stdin config on the GPU, `--cpu` on CPU, `--default` prints the
sample config (main.cu:552-570). Without `--cpu` the run needs a GPU and
exits with an error when JAX finds none. Extends the reference with
explicit flags: --config FILE, --backend gpu|cpu, --format bin|png|ppm,
--frames, --bvh, --smoke.

Usage:
  python -m tracer.cli --default > config.txt
  python -m tracer.cli --gpu < config.txt
  python -m tracer.cli --config config.txt --backend gpu --format png
  python -m tracer.cli --fit target.png --config config.txt \
      --fit-params materials.albedo --fit-steps 200
"""

from __future__ import annotations

import argparse
import os
import sys


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tracer", description=__doc__)
    p.add_argument("--gpu", action="store_true", help="render on the GPU (reference --gpu; the default)")
    p.add_argument("--cpu", action="store_true", help="render on CPU (reference --cpu)")
    p.add_argument("--default", action="store_true", help="print the sample config and exit")
    p.add_argument("--smoke", action="store_true", help="print the fast smoke-test config and exit")
    p.add_argument("--config", type=str, default=None, help="config file (default: stdin)")
    p.add_argument("--backend", choices=["gpu", "cpu"], default="gpu")
    p.add_argument("--format", choices=["bin", "png", "ppm"], default="bin",
                   help="output format (bin matches the reference BinarySaver)")
    p.add_argument("--frames", type=int, default=None, help="render only the first N frames")
    p.add_argument("--bvh", action="store_true", help="use BVH traversal instead of brute force")
    p.add_argument("--rr", type=int, default=None, metavar="DEPTH",
                   help="Russian-roulette path termination from bounce DEPTH on "
                        "(unbiased deep-scene speedup; off by default for "
                        "reference-estimator parity)")
    p.add_argument("--retries", type=int, default=0, metavar="N",
                   help="retry each frame up to N times on transient backend "
                        "failures (lost worker, dropped connection)")
    p.add_argument("--no-quirk", action="store_true",
                   help="use corrected j*width+i pixel seeding instead of the reference quirk")
    p.add_argument("--stratify", action="store_true",
                   help="stratified sub-pixel sampling (sqrt_spp x sqrt_spp grid) "
                        "instead of the reference's uniform jitter")
    p.add_argument("--ref-rng", action="store_true",
                   help="reference-stream RNG: per-ray wang_hash streams advance "
                        "exactly like the reference binary (rejection sampling)")
    p.add_argument("--no-saver-quirk", action="store_true",
                   help="divide saved images by the true sample count instead of "
                        "the reference's sqrt_spp (camera.cu:300)")
    p.add_argument("--fit", metavar="TARGET", default=None,
                   help="inverse rendering: fit scene parameters to a target "
                        "image (png/bin written by this tool) instead of rendering")
    p.add_argument("--fit-params", default="materials.albedo",
                   help="comma-separated dotted Scene paths to optimize")
    p.add_argument("--fit-steps", type=int, default=100)
    p.add_argument("--fit-lr", type=float, default=1e-2)
    p.add_argument("--fit-checkpoint", default=None,
                   help="npz checkpoint path (resumes if it exists)")
    return p


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from tracer.scene import config as config_mod

    if args.default:
        sys.stdout.write(config_mod.default_config_text())
        return 0
    if args.smoke:
        sys.stdout.write(config_mod.smoke_config_text())
        return 0

    if args.cpu and args.gpu:
        print("tracer: --cpu and --gpu are exclusive", file=sys.stderr)
        return 2
    backend = "cpu" if args.cpu else "gpu" if args.gpu else args.backend
    import jax

    from tracer.utils import compile_cache

    if backend == "cpu":
        jax.config.update("jax_platforms", "cpu")
    elif jax.default_backend() != "gpu":
        print(f"tracer: no GPU found (JAX backend is {jax.default_backend()!r}); "
              "pass --cpu to render on the CPU", file=sys.stderr)
        return 1
    compile_cache.enable()

    try:
        if args.config:
            with open(args.config) as f:
                params = config_mod.read_scene_params(f)
        else:
            params = config_mod.read_scene_params(sys.stdin)
    except (ValueError, OSError) as e:
        print(f"tracer: bad config: {e}", file=sys.stderr)
        return 2
    if args.frames is not None:
        params.num_frames = min(params.num_frames, args.frames)

    from tracer.render import driver
    from tracer.scene import builders

    scene = builders.create_scene(params, with_bvh=args.bvh)

    if args.fit:
        return _run_fit(args, scene, params)

    out_dir = os.path.dirname(params.output_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    driver.render_animation(
        scene,
        params,
        intersector="bvh" if args.bvh else "fast",
        saver=args.format,
        reference_quirk=not args.no_quirk,
        saver_spp_quirk=not args.no_saver_quirk,
        rng_mode="reference" if args.ref_rng else "fixed",
        stratify=args.stratify,
        retries=args.retries,
        rr_start=args.rr,
    )
    return 0


def _run_fit(args, scene, params) -> int:
    """Fit the named scene parameters to a target image (see tracer.opt)."""
    import numpy as np

    from tracer.io import image as image_io
    from tracer.opt import fit as fit_mod
    from tracer.render import camera as camera_mod

    # Dispatch on CONTENT, not extension: the default (reference-parity)
    # saver writes raw int32-header binary frames to .png-named paths
    # (camera.cu:298-300). PNG/PPM magics are unambiguous; anything else
    # is our binary.
    with open(args.fit, "rb") as f:
        magic = f.read(2)
    if magic in (b"\x89P", b"P3", b"P6"):
        q = image_io.read_image(args.fit).astype(np.float32)
    else:
        q = image_io.read_binary(args.fit).astype(np.float32)
    sqrt_spp = params.render.sqrt_rays_per_pixel
    spp = sqrt_spp * sqrt_spp
    # invert the saver quantize (camera.cu:64-73): byte = int(256*sqrt(sum/div)),
    # so sum/div lies in [(b/256)^2, ((b+1)/256)^2) — centering the sqrt-domain
    # dequantization at b+0.5 removes the systematic low bias (ADVICE round 1)
    divisor = spp if args.no_saver_quirk else sqrt_spp
    target = ((q + 0.5) / 256.0) ** 2 * (divisor / spp)
    h, w = target.shape[:2]
    if (w, h) != (params.width, params.height):
        print(f"tracer: target is {w}x{h}, config says "
              f"{params.width}x{params.height}", file=sys.stderr)
        return 2

    lookfrom, lookat = camera_mod.camera_path_position(
        params.camera_path, 0, params.num_frames
    )
    cam = camera_mod.build_camera_data(
        origin=lookfrom, look_at=lookat, width=w, height=h,
        vfov=params.fov_degrees,
    )
    paths = tuple(p for p in args.fit_params.split(",") if p)
    # "camera.*" params (pose/fov estimation): the config's frame-0
    # camera position seeds the differentiable spec
    cam_spec = None
    if any(p.startswith("camera.") for p in paths):
        cam_spec = dict(origin=lookfrom, look_at=lookat,
                        vfov=float(params.fov_degrees))
    out = fit_mod.fit(
        scene, cam, target, w, h,
        spp=spp, max_depth=params.render.max_depth,
        param_paths=paths,
        steps=args.fit_steps, learning_rate=args.fit_lr,
        checkpoint_path=args.fit_checkpoint,
        cam_spec=cam_spec,
    )
    if cam_spec is not None:
        fitted, losses, fitted_spec = out
    else:
        fitted, losses = out
        fitted_spec = None
    for path in paths:
        if path.startswith("camera."):
            val = fitted_spec[path[len("camera."):]]
        else:
            val = fit_mod.get_path(fitted, path)
        print(f"{path} = {np.asarray(val).tolist()}")
    print(f"final loss: {losses[-1] if losses else float('nan'):.6g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
