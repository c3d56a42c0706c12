"""Multi-device sharded rendering on the virtual 8-device CPU mesh.

SURVEY.md §7 stage 7 / §4: N-host logic validated without a pod via
xla_force_host_platform_device_count (set in conftest.py).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer.dist import sharding
from tracer.render import camera as C
from tracer.render import renderer
from tracer.scene import types as T

W, H = 16, 12


def _scene():
    spheres = T.make_spheres([[0, 0, 1.0], [3, 3, 5.0]], [1.0, 2.0], [0, 2])
    planes = T.make_planes([T.QUAD], [[-10, -10, 0]], [[20, 0, 0]], [[0, 20, 0]], [1])
    mats = T.make_materials(
        [T.LAMBERTIAN, T.LAMBERTIAN, T.DIFFUSE_LIGHT],
        [0, 0, 0], [1, 1, 1], np.zeros((3, 3)),
        [[0.7, 0.3, 0.3], [0.5, 0.5, 0.5], [0, 0, 0]],
        [[0, 0, 0], [0, 0, 0], [8, 8, 8]], [-1, -1, -1],
    )
    return T.Scene(spheres, planes, mats, None, None)


def _cam():
    return C.build_camera_data([4, -4, 2.5], [0, 0, 1], W, H, 60.0, background=(0.1, 0.1, 0.2))


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return sharding.make_mesh(jax.devices()[:8])


class TestShardedRender:
    def test_matches_single_device(self, mesh):
        scene, cam = _scene(), _cam()
        fb1 = np.asarray(renderer.render_frame(scene, cam, W, H, spp=2, max_depth=4, chunk=W * H))
        fb8 = np.asarray(
            sharding.render_frame_sharded(scene, cam, W, H, spp=2, max_depth=4, mesh=mesh, chunk=W * H)
        )
        # per-pixel seeding makes the shard split invisible: bit-identical
        np.testing.assert_allclose(fb8, fb1, atol=1e-6)

    def test_uneven_pixel_count(self, mesh):
        # 15x7 = 105 pixels does not divide 8; padding must be transparent
        scene, cam = _scene(), C.build_camera_data([4, -4, 2.5], [0, 0, 1], 15, 7, 60.0)
        fb1 = np.asarray(renderer.render_frame(scene, cam, 15, 7, spp=1, max_depth=3, chunk=128))
        fb8 = np.asarray(
            sharding.render_frame_sharded(scene, cam, 15, 7, spp=1, max_depth=3, mesh=mesh, chunk=128)
        )
        np.testing.assert_allclose(fb8, fb1, atol=1e-6)


class TestShardedGrads:
    def test_grads_match_single_device(self, mesh):
        scene, cam = _scene(), _cam()
        target = np.zeros((H, W, 3), np.float32)

        def loss_single(scene):
            fb = renderer.render_frame(scene, cam, W, H, spp=1, max_depth=3, chunk=W * H)
            return jnp.mean((fb / 1 - target) ** 2)

        loss1, g1 = jax.value_and_grad(loss_single, allow_int=True)(scene)
        loss8, g8 = sharding.scene_grads_sharded(
            scene, cam, target, W, H, spp=1, max_depth=3, mesh=mesh
        )
        np.testing.assert_allclose(float(loss8), float(loss1), rtol=1e-6)
        np.testing.assert_allclose(
            np.asarray(g8.materials.albedo), np.asarray(g1.materials.albedo), rtol=1e-4, atol=1e-7
        )
        np.testing.assert_allclose(
            np.asarray(g8.spheres.center), np.asarray(g1.spheres.center), rtol=1e-4, atol=1e-7
        )


class TestGraftEntry:
    def test_entry_compiles(self):
        import os
        import sys

        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        assert out.shape == (48, 64, 3)
        assert np.isfinite(np.asarray(out)).all()

    def test_dryrun_multichip(self):
        import os
        import sys

        sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        import __graft_entry__ as ge

        ge.dryrun_multichip(8)


class TestSppSharding:
    def test_spp_sharded_matches_single(self, mesh):
        from tracer.dist import sharding as S

        scene, cam = _scene(), _cam()
        fb1 = np.asarray(renderer.render_frame(scene, cam, W, H, spp=8, max_depth=3, chunk=W * H))
        fb8 = np.asarray(
            S.render_frame_spp_sharded(scene, cam, W, H, spp=8, max_depth=3, mesh=mesh)
        )
        np.testing.assert_allclose(fb8, fb1, rtol=1e-5, atol=1e-5)

    def test_spp_not_divisible_raises(self, mesh):
        from tracer.dist import sharding as S

        with pytest.raises(AssertionError):
            S.render_frame_spp_sharded(_scene(), _cam(), W, H, spp=7, max_depth=2, mesh=mesh)


class TestShardedModeForwarding:
    def test_mesh_path_forwards_stratify_and_rng(self, mesh):
        from tracer.dist import sharding as S

        scene, cam = _scene(), _cam()
        for kw in (dict(stratify=True, spp=4), dict(rng_mode="reference", spp=2)):
            spp = kw.pop("spp")
            fb1 = np.asarray(
                renderer.render_frame(scene, cam, W, H, spp=spp, max_depth=3, chunk=W * H, **kw)
            )
            fb8 = np.asarray(
                S.render_frame_sharded(scene, cam, W, H, spp, 3, mesh=mesh, chunk=W * H, **kw)
            )
            np.testing.assert_allclose(fb8, fb1, atol=1e-6)

    def test_driver_mesh_path(self, tmp_path):
        import io as _io

        from tracer.dist import sharding as S
        from tracer.render import driver
        from tracer.scene import builders, config
        import jax

        params = config.read_scene_params(_io.StringIO(config.smoke_config_text()))
        params.width, params.height = 16, 8
        params.num_frames = 1
        params.render.sqrt_rays_per_pixel = 1
        params.render.max_depth = 2
        params.output_path = str(tmp_path / "m_%d.bin")
        scene = builders.create_scene(params, texture_loader=lambda _: None)
        mesh = S.make_mesh(jax.devices()[:8])
        fb_m = driver.render_animation(scene, params, mesh=mesh, out=_io.StringIO(),
                                       stratify=False, rng_mode="fixed")
        fb_s = driver.render_animation(scene, params, out=_io.StringIO())
        np.testing.assert_allclose(fb_m, fb_s, atol=1e-6)


    def test_spp_sharded_forwards_modes(self, mesh):
        from tracer.dist import sharding as S

        scene, cam = _scene(), _cam()
        fb1 = np.asarray(
            renderer.render_frame(scene, cam, W, H, spp=16, max_depth=3, chunk=W * H, stratify=True)
        )
        fb8 = np.asarray(
            S.render_frame_spp_sharded(scene, cam, W, H, 16, 3, mesh=mesh, stratify=True)
        )
        np.testing.assert_allclose(fb8, fb1, rtol=1e-5, atol=1e-5)


class TestMultiProcess:
    """2-process jax.distributed on CPU: the global-mesh allgather branch
    of multihost.render_animation_multihost (VERDICT round-1 item 7)."""

    def test_two_process_global_mesh_render(self, tmp_path):
        import io as _io
        import os
        import socket
        import subprocess
        import sys

        # free port for the coordinator
        s = socket.socket()
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
        s.close()

        worker = os.path.join(os.path.dirname(__file__), "mp_render_worker.py")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("JAX_", "XLA_"))}
        procs = [
            subprocess.Popen(
                [sys.executable, worker, str(pid), str(port), str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True,
            )
            for pid in range(2)
        ]
        for p in procs:
            try:
                out, err = p.communicate(timeout=420)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            assert p.returncode == 0, f"worker failed:\n{out}\n{err[-3000:]}"

        # only process 0 writes TSV timing lines
        tsv0 = (tmp_path / "tsv_0.txt").read_text()
        tsv1 = (tmp_path / "tsv_1.txt").read_text()
        assert len(tsv0.strip().splitlines()) == 2
        assert tsv1.strip() == ""

        # frames written once (by process 0) and match a single-process render
        from tracer.io import image as image_io
        from tracer.render import driver
        from tracer.scene import builders, config

        params = config.read_scene_params(_io.StringIO(config.smoke_config_text()))
        params.width, params.height = 16, 8
        params.num_frames = 2
        params.render.sqrt_rays_per_pixel = 1
        params.render.max_depth = 2
        params.output_path = str(tmp_path / "ref_%d.bin")
        scene = builders.create_scene(params, texture_loader=lambda _: None)
        driver.render_animation(scene, params, out=_io.StringIO(),
                                stratify=False, rng_mode="fixed")
        for n in range(2):
            got = image_io.read_binary(str(tmp_path / f"mh_{n}.bin"))
            want = image_io.read_binary(str(tmp_path / f"ref_{n}.bin"))
            np.testing.assert_array_equal(got, want)


class TestPallasSharded:
    """Sharded gradients with the backward in spp chunks
    (sharding.l2_grads_deep_sharded, the config-5 runner): loss and every
    gradient leaf match the single-device tracer.opt.grads.l2_grads_deep
    up to f32 reduction order."""

    def _scene(self, textured=False):
        import io as _io

        from tracer.scene import builders, config

        params = config.read_scene_params(_io.StringIO(config.smoke_config_text()))
        scene = builders.create_scene(params, with_bvh=False,
                                      texture_loader=lambda _: None)
        if textured:
            g = np.random.default_rng(7)
            tex = jnp.asarray(g.uniform(0.2, 1.0, (1, 40, 56, 3)).astype(np.float32))
            tid = np.asarray(scene.materials.tex_id).copy()
            tid[0] = 0
            scene = scene._replace(
                textures=tex,
                materials=scene.materials._replace(tex_id=jnp.asarray(tid)),
            )
        return scene

    def _check(self, mesh, textured=False, spp=4, spp_chunk=2):
        from tracer.opt import grads

        scene = self._scene(textured)
        w, h, depth = 32, 20, 3  # 640 px over 8 devices; 20 rows
        cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], w, h, 90.0)
        target = np.zeros((h, w, 3), np.float32)

        l_ref, gs_ref, gc_ref = grads.l2_grads_deep(
            scene, cam, target, w, h, spp, depth, spp_chunk=spp_chunk)
        l_sh, gs_sh, gc_sh = sharding.l2_grads_deep_sharded(
            scene, cam, target, w, h, spp, depth, mesh, spp_chunk=spp_chunk)
        np.testing.assert_allclose(float(l_sh), float(l_ref), rtol=1e-6)
        for a, b in zip(
            jax.tree_util.tree_leaves(gs_sh) + jax.tree_util.tree_leaves(gc_sh),
            jax.tree_util.tree_leaves(gs_ref) + jax.tree_util.tree_leaves(gc_ref),
        ):
            if jnp.issubdtype(a.dtype, jnp.floating):
                tol = 1e-5 * max(1.0, float(np.abs(np.asarray(b)).max()))
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           atol=tol, rtol=1e-4)
        return gs_ref

    def test_sharded_kernel_backward_matches_unsharded(self, mesh):
        self._check(mesh)

    def test_sharded_kernel_backward_texture_grads(self, mesh):
        """Textured scene: the texture image's gradient comes from
        autodiff, is nonzero, and matches leaf for leaf."""
        gs = self._check(mesh, textured=True)
        assert float(np.abs(np.asarray(gs.textures)).max()) > 0.0

    @pytest.mark.parametrize("n_dev", [2, 4, 8])
    def test_sharded_chunked_grads_any_mesh_size(self, n_dev):
        self._check(sharding.make_mesh(jax.devices()[:n_dev]), spp=2, spp_chunk=1)


def _bvh_scene():
    from tracer.bvh import builder as bvh_builder

    scene = _scene()
    bvh = bvh_builder.build_bvh_arrays(
        np.asarray(scene.spheres.center), np.asarray(scene.spheres.radius),
        np.asarray(scene.planes.base), np.asarray(scene.planes.u),
        np.asarray(scene.planes.v), np.asarray(scene.planes.ptype),
    )
    return scene._replace(bvh=bvh)


def _textured_scene():
    scene = _scene()
    g = np.random.default_rng(2)
    tex = jnp.asarray(g.uniform(0.2, 1.0, (1, 24, 32, 3)).astype(np.float32))
    return scene._replace(
        textures=tex,
        materials=scene.materials._replace(tex_id=jnp.asarray([-1, 0, -1], jnp.int32)),
    )


# mode -> (scene factory, render_frame keyword arguments)
SHARDED_MODES = {
    "rr": (_scene, dict(spp=2, max_depth=6, rr_start=1)),
    "stratify": (_scene, dict(spp=4, max_depth=3, stratify=True)),
    "ref_rng": (_scene, dict(spp=2, max_depth=3, rng_mode="reference")),
    "textured": (_textured_scene, dict(spp=2, max_depth=3)),
    "bvh": (_bvh_scene, dict(spp=2, max_depth=3, intersector="bvh")),
}


@pytest.mark.parametrize("mode", sorted(SHARDED_MODES))
def test_sharded_render_matches_single_device(mesh, mode):
    """Tile sharding only partitions the pixel axis, so every render mode
    gives the single-device frame."""
    make_scene, kw = SHARDED_MODES[mode]
    scene, cam = make_scene(), _cam()
    fb1 = np.asarray(renderer.render_frame(scene, cam, W, H, chunk=W * H, **kw))
    fb8 = np.asarray(sharding.render_frame_sharded(scene, cam, W, H, mesh=mesh,
                                                   chunk=W * H, **kw))
    np.testing.assert_allclose(fb8, fb1, atol=1e-6)
    assert fb1.max() > 0
