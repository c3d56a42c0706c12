"""Inverse-rendering fit: loss descends, checkpoints resume exactly."""

import numpy as np

from tracer.opt import fit as fit_mod
from tracer.render import camera as C
from tracer.render import renderer
from tracer.scene import types as T

W, H, SPP, DEPTH = 12, 8, 2, 3


def _scene(albedo0=(0.7, 0.3, 0.3)):
    spheres = T.make_spheres([[0, 0, 1.0], [3, 3, 5.0]], [1.0, 1.5], [0, 2])
    planes = T.make_planes([T.QUAD], [[-10, -10, 0]], [[20, 0, 0]], [[0, 20, 0]], [1])
    mats = T.make_materials(
        [T.LAMBERTIAN, T.LAMBERTIAN, T.DIFFUSE_LIGHT],
        [0, 0, 0], [1, 1, 1], np.zeros((3, 3)),
        [list(albedo0), [0.5, 0.5, 0.5], [0, 0, 0]],
        [[0, 0, 0], [0, 0, 0], [8, 8, 8]], [-1, -1, -1],
    )
    return T.Scene(spheres, planes, mats, None, None)


def _cam():
    return C.build_camera_data([4, -4, 2.5], [0, 0, 1], W, H, 60.0, background=(0.1, 0.1, 0.2))


def _target(scene):
    fb = renderer.render_frame(scene, _cam(), W, H, spp=SPP, max_depth=DEPTH, chunk=W * H)
    return np.asarray(fb) / SPP


class TestPathHelpers:
    def test_get_set_roundtrip(self):
        scene = _scene()
        v = fit_mod.get_path(scene, "materials.albedo")
        scene2 = fit_mod.set_path(scene, "materials.albedo", v * 2)
        np.testing.assert_allclose(np.asarray(scene2.materials.albedo), np.asarray(v) * 2)
        # untouched leaves identical
        np.testing.assert_allclose(
            np.asarray(scene2.spheres.center), np.asarray(scene.spheres.center)
        )


class TestFit:
    def test_albedo_recovers(self):
        true_scene = _scene(albedo0=(0.2, 0.8, 0.4))
        target = _target(true_scene)
        init = _scene(albedo0=(0.5, 0.5, 0.5))
        fitted, losses = fit_mod.fit(
            init, _cam(), target, W, H, spp=SPP, max_depth=DEPTH,
            param_paths=("materials.albedo",), steps=60, learning_rate=5e-2,
            log_every=0,
        )
        assert min(losses) < losses[0] * 0.5, (losses[0], min(losses))
        got = np.asarray(fitted.materials.albedo)[0]
        want = np.array([0.2, 0.8, 0.4])
        assert np.abs(got - want).max() < 0.1, got

    def test_checkpoint_resume_bitexact(self, tmp_path):
        true_scene = _scene(albedo0=(0.3, 0.6, 0.2))
        target = _target(true_scene)
        init = _scene(albedo0=(0.5, 0.5, 0.5))
        kw = dict(
            param_paths=("materials.albedo",), learning_rate=3e-2, log_every=0,
            spp=SPP, max_depth=DEPTH,
        )
        # one uninterrupted 12-step run
        full, _ = fit_mod.fit(init, _cam(), target, W, H, steps=12, **kw)

        # 6 steps + checkpoint, then resume for the remaining 6
        ck = str(tmp_path / "fit.npz")
        fit_mod.fit(init, _cam(), target, W, H, steps=6, checkpoint_path=ck,
                    checkpoint_every=100, **kw)
        resumed, _ = fit_mod.fit(init, _cam(), target, W, H, steps=12,
                                 checkpoint_path=ck, checkpoint_every=100, **kw)
        np.testing.assert_allclose(
            np.asarray(resumed.materials.albedo),
            np.asarray(full.materials.albedo),
            rtol=1e-6, atol=1e-7,
        )


class TestTexturedFit:
    def test_textured_albedo_recovers_pallas(self):
        """Inverse rendering on a TEXTURED scene: the albedo fit
        converges with the texture sampled inside the differentiated
        render."""
        import numpy as np

        import jax.numpy as jnp

        g = np.random.default_rng(0)
        tex = jnp.asarray(g.uniform(0.2, 1.0, (1, 64, 96, 3)).astype(np.float32))

        def make(albedo0):
            mats = T.make_materials(
                [T.METAL, T.LAMBERTIAN, T.DIFFUSE_LIGHT],
                [0.05, 0, 0], [1, 1, 1], np.zeros((3, 3)),
                [[0.9, 0.9, 0.9], list(albedo0), [0, 0, 0]],
                [[0, 0, 0], [0, 0, 0], [9, 8, 7]], [0, -1, -1],
            )
            spheres = T.make_spheres([[0.4, -0.3, 1.2], [4, 3, 6]], [1.2, 1.0], [1, 2])
            planes = T.make_planes([T.QUAD], [[-12, -12, 0]], [[24, 0, 0]],
                                   [[0, 24, 0]], [0])
            return T.Scene(spheres, planes, mats, tex, None)

        # big enough that the sphere subtends real pixels — tiny frames
        # leave the loss noise-dominated
        fw, fh = 64, 48
        cam = C.build_camera_data([9, -9, 5], [0, 0, 1.2], fw, fh, 55.0,
                                  background=(0.05, 0.05, 0.1))
        from tracer.render import renderer

        true_scene = make([0.2, 0.7, 0.4])
        fb = renderer.render_frame(true_scene, cam, fw, fh, 2, 4)
        target = np.asarray(fb) / 2
        init = make([0.6, 0.3, 0.6])
        _, losses = fit_mod.fit(
            init, cam, target, fw, fh, spp=2, max_depth=4,
            param_paths=("materials.albedo",), steps=8, learning_rate=3e-2,
            log_every=0)
        assert losses[-1] < losses[0] * 0.8, (losses[0], losses[-1])


class TestCameraFit:
    def test_camera_origin_recovers(self):
        """param_paths entries "camera.*" + cam_spec optimize the camera:
        the loss rebuilds the look-at basis differentiably each step.

        The scene needs a SMOOTH radiance dependence on the camera for
        the straight-through gradient to be informative (path radiance is
        piecewise-constant in geometry otherwise) — a ramp-textured floor
        provides it: moving the camera slides the texels under every
        floor-hitting path.
        """
        import jax.numpy as jnp

        ramp = np.zeros((1, 32, 32, 3), np.float32)
        ramp[0, :, :, 0] = np.linspace(0.1, 1.0, 32)[None, :]
        ramp[0, :, :, 1] = np.linspace(1.0, 0.1, 32)[:, None]
        ramp[0, :, :, 2] = 0.5
        scene = _scene()
        tid = np.asarray(scene.materials.tex_id).copy()
        tid[1] = 0  # floor material textured
        scene = scene._replace(
            textures=jnp.asarray(ramp),
            materials=scene.materials._replace(tex_id=jnp.asarray(tid)))

        fw, fh = 48, 32  # straight-through camera grads need the smooth
        # (texture-slide) term to dominate the discrete silhouette jumps:
        # enough pixels, small initial offset, gentle steps
        true_origin = [4.0, -4.0, 2.5]
        base = dict(look_at=[0.0, 0.0, 1.0], vfov=60.0,
                    background=(0.1, 0.1, 0.2))
        cam_true = C.build_camera_data(true_origin, base["look_at"], fw, fh,
                                       60.0, background=base["background"])
        target = np.asarray(renderer.render_frame(
            scene, cam_true, fw, fh, spp=SPP, max_depth=DEPTH, chunk=fw * fh)) / SPP

        spec0 = dict(base, origin=[4.06, -3.95, 2.54])
        cam0 = C.build_camera_data(spec0["origin"], base["look_at"], fw, fh,
                                   60.0, background=base["background"])
        fitted, losses, fitted_spec = fit_mod.fit(
            scene, cam0, target, fw, fh, spp=SPP, max_depth=DEPTH,
            param_paths=("camera.origin",), cam_spec=spec0, steps=30,
            learning_rate=1e-3, log_every=0)
        # the camera gradient must pull the loss down substantially; the
        # piecewise-smooth landscape (silhouette jumps) makes the LAST
        # iterate oscillate, so pin the best-reached loss
        assert min(losses) < losses[0] * 0.5, (losses[0], min(losses))
