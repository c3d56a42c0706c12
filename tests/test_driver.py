"""Frame driver: camera path math, TSV output, CLI subprocess smoke."""

import io
import math
import os
import subprocess
import sys

import numpy as np
import pytest

from tracer.render import camera as C
from tracer.render import driver
from tracer.scene import builders, config
from tracer.scene.params import CameraPathParams


class TestCameraPath:
    def test_sinusoidal_cylindrical(self):
        # reference src/camera.cu:303-315
        p = CameraPathParams(
            rc0=15.0, zc0=4.5, phic0=math.pi, arc=2.0, azc=1.0,
            wrc=1.0, wzc=2.0, wc=1.0, prc=0.5, pzc=-1.57,
            rn0=1.0, zn0=4.5, phin0=0.0, arn=0.0, azn=0.0,
            wrn=0.0, wzn=0.0, wn=0.0, prn=0.0, pzn=0.0,
        )
        n, num = 7, 100
        lookfrom, lookat = C.camera_path_position(p, n, num)
        t = (n / num) * 2.0 * math.pi
        r_c = 15.0 + 2.0 * math.sin(1.0 * t + 0.5)
        z_c = 4.5 + 1.0 * math.sin(2.0 * t - 1.57)
        phi_c = math.pi + 1.0 * t
        want_from = [r_c * math.cos(phi_c), r_c * math.sin(phi_c), z_c]
        np.testing.assert_allclose(np.asarray(lookfrom), want_from, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(lookat), [1.0, 0.0, 4.5], atol=1e-6)

    def test_frame_zero_matches_initial_phase(self):
        p = CameraPathParams(rc0=10.0, phic0=0.0, zc0=2.0)
        lookfrom, _ = C.camera_path_position(p, 0, 50)
        np.testing.assert_allclose(np.asarray(lookfrom), [10.0, 0.0, 2.0], atol=1e-6)


class TestAnimationDriver:
    def test_tsv_and_files(self, tmp_path):
        params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
        params.width, params.height = 16, 8
        params.num_frames = 2
        params.render.sqrt_rays_per_pixel = 1
        params.render.max_depth = 2
        params.output_path = str(tmp_path / "f_%d.bin")
        scene = builders.create_scene(params, texture_loader=lambda _: None)
        out = io.StringIO()
        driver.render_animation(scene, params, out=out)
        lines = [l for l in out.getvalue().splitlines() if l]
        assert len(lines) == 2
        for n, line in enumerate(lines):
            f, ms, rays = line.split("\t")
            assert int(f) == n and float(ms) > 0
            assert int(rays) == 16 * 8 * 1  # total_rays (camera.cu:344-345)
        assert os.path.exists(tmp_path / "f_0.bin")
        assert os.path.exists(tmp_path / "f_1.bin")

    def test_frames_subset(self, tmp_path):
        params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
        params.width, params.height = 8, 8
        params.num_frames = 10
        params.render.sqrt_rays_per_pixel = 1
        params.render.max_depth = 2
        params.output_path = str(tmp_path / "g_%d.bin")
        scene = builders.create_scene(params, texture_loader=lambda _: None)
        driver.render_animation(scene, params, frames=[3, 7], out=io.StringIO())
        assert sorted(os.listdir(tmp_path)) == ["g_3.bin", "g_7.bin"]


class TestCliDevice:
    @pytest.mark.parametrize("flag", ["--pallas", "--fast-math"])
    def test_removed_kernel_flags_are_rejected(self, flag, capsys):
        from tracer import cli as cli_mod

        with pytest.raises(SystemExit) as e:
            cli_mod.main([flag, "--config", "unused.cfg"])
        assert e.value.code == 2
        assert flag in capsys.readouterr().err

    @pytest.mark.parametrize("argv", [[], ["--gpu"], ["--backend", "gpu"]])
    def test_no_gpu_is_an_error(self, argv, capsys):
        """Without --cpu the CLI renders on the GPU or not at all (the
        tests run on the CPU backend)."""
        from tracer import cli as cli_mod

        rc = cli_mod.main(argv + ["--config", "unused.cfg"])
        assert rc != 0
        assert "no GPU" in capsys.readouterr().err

    def test_cpu_and_gpu_are_exclusive(self):
        from tracer import cli as cli_mod

        assert cli_mod.main(["--cpu", "--gpu", "--config", "unused.cfg"]) == 2


@pytest.mark.slow
class TestCliSubprocess:
    def test_default_emitter(self):
        r = subprocess.run(
            [sys.executable, "-m", "tracer.cli", "--default"],
            capture_output=True, text=True, timeout=60,
        )
        assert r.returncode == 0
        p = config.read_scene_params(io.StringIO(r.stdout))
        assert p.num_frames == 100

    def test_bad_config_exit_2(self):
        r = subprocess.run(
            [sys.executable, "-m", "tracer.cli", "--cpu"],
            input="1 bad", capture_output=True, text=True, timeout=300,
        )
        assert r.returncode == 2
        assert "bad config" in r.stderr

    def test_flag_wiring_rr_fastmath_png(self, tmp_path):
        """--rr/--format png wire through main() to a rendered frame
        (in-process, on the CPU)."""
        from tracer import cli as cli_mod

        cfg = config.smoke_config_text().replace("200 100 90", "24 16 90")
        cfg = cfg.replace("test_output_%d.png", str(tmp_path / "f_%d.png"))
        cfg_path = tmp_path / "c.cfg"
        cfg_path.write_text(cfg)
        rc = cli_mod.main([
            "--cpu", "--config", str(cfg_path),
            "--rr", "2", "--format", "png", "--frames", "1",
        ])
        assert rc == 0
        from PIL import Image

        im = Image.open(tmp_path / "f_0.png")
        assert im.size == (24, 16)


class TestStratifiedSampling:
    def test_offsets_confined_to_cells(self):
        import jax.numpy as jnp

        from tracer.core import rng as rng_mod

        cam = C.build_camera_data([0, 0, 5], [0, 0, 0], 4, 4, 60.0, vup=(0, 1, 0))
        i = jnp.zeros((64,), jnp.uint32)
        j = jnp.zeros((64,), jnp.uint32)
        seeds = jnp.arange(64, dtype=jnp.uint32) * jnp.uint32(2654435761)
        # sample 0 of a 2x2 stratification must land in the lower-left
        # quarter-pixel: offsets in [-0.5, 0)
        _, _, d0 = C.get_rays(cam, i, j, seeds, sample_index=jnp.zeros((64,), jnp.uint32), sqrt_spp=2)
        _, _, d3 = C.get_rays(cam, i, j, seeds, sample_index=jnp.full((64,), 3, jnp.uint32), sqrt_spp=2)
        # recompute offsets by inverting the pixel basis: project onto du
        du = np.asarray(cam.pixel_delta_u)
        pc = np.asarray(cam.pixel00_loc)
        o = np.asarray(cam.origin)
        off0 = (np.asarray(d0) + o - pc) @ du / (du @ du)
        off3 = (np.asarray(d3) + o - pc) @ du / (du @ du)
        assert (off0 >= -0.5 - 1e-5).all() and (off0 < 0.0 + 1e-5).all()
        assert (off3 >= 0.0 - 1e-5).all() and (off3 < 0.5 + 1e-5).all()

    def test_stratified_variance_reduction(self):
        # edge-on view of a sphere: stratification should reduce the
        # pixel-level MC variance vs uniform jitter.
        from tracer.render import renderer
        from tracer.scene import types as T

        spheres = T.make_spheres([[0, 0, 0.0]], [1.0], [0])
        mats = T.make_materials([T.DIFFUSE_LIGHT], [0], [1], np.zeros((1, 3)),
                                [[0, 0, 0]], [[1, 1, 1]], [-1])
        scene = T.Scene(spheres, T.empty_planes(), mats, None, None)
        cam = C.build_camera_data([0, 0, 4], [0, 0, 0], 24, 24, 30.0, vup=(0, 1, 0))
        spp = 16
        uni = np.asarray(renderer.render_frame(scene, cam, 24, 24, spp=spp, max_depth=2, chunk=576)) / spp
        strat = np.asarray(
            renderer.render_frame(scene, cam, 24, 24, spp=spp, max_depth=2, chunk=576, stratify=True)
        ) / spp
        ref = np.asarray(
            renderer.render_frame(scene, cam, 24, 24, spp=1024, max_depth=2, chunk=576, stratify=True)
        ) / 1024
        err_u = np.abs(uni - ref).mean()
        err_s = np.abs(strat - ref).mean()
        assert err_s < err_u, (err_s, err_u)
