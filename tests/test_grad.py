"""Gradient correctness: jax.grad vs central finite differences.

SURVEY.md §7 stage 6 / BASELINE.md gradient-parity gate: pixel losses
must backpropagate to sphere centers/radii, material albedo/fuzz/ir/
absorption/emit, and camera parameters. Finite differences are computed
with the SAME renderer (straight-through convention: discrete decisions
— hit selection, RNG gates — are fixed; at these scene params no gate
flips within +-h, so FD and AD see the same smooth branch).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tracer.render import camera as C
from tracer.render import renderer
from tracer.scene import types as T

W, H, SPP, DEPTH = 12, 8, 2, 4


def _scene(center_z=1.0, radius=1.0, albedo=(0.7, 0.3, 0.3), emit=(6.0, 5.0, 4.0),
           fuzz=0.25, ir=1.5, absorption=(0.3, 0.5, 0.1)):
    spheres = T.make_spheres(
        [[0.0, 0.0, center_z], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0], [0.0, 2.5, 4.0]],
        [radius, 1.0, 1.0, 1.0],
        [0, 1, 2, 3],
    )
    planes = T.make_planes([T.QUAD], [[-8, -8, 0]], [[16, 0, 0]], [[0, 16, 0]], [4])
    mats = T.make_materials(
        mtype=[T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.LAMBERTIAN],
        fuzz=[0.0, fuzz, 0.0, 0.0, 0.0],
        ir=[1.0, 1.0, ir, 1.0, 1.0],
        absorption=[[0, 0, 0], [0, 0, 0], list(absorption), [0, 0, 0], [0, 0, 0]],
        albedo=[list(albedo), [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.5, 0.5, 0.5]],
        emit=[[0, 0, 0], [0, 0, 0], [0, 0, 0], list(emit), [0, 0, 0]],
        tex_id=[-1] * 5,
    )
    return T.Scene(spheres, planes, mats, None, None)


CAM = None


def _cam():
    global CAM
    if CAM is None:
        CAM = C.build_camera_data([5.0, -6.0, 3.0], [0.0, 0.0, 1.0], W, H, 55.0,
                                  background=(0.05, 0.07, 0.1))
    return CAM


def _loss_fb(scene, cam=None):
    fb = renderer.render_frame(scene, cam or _cam(), W, H, spp=SPP, max_depth=DEPTH, chunk=W * H)
    return jnp.sum(fb * fb) / (W * H * SPP)


def _fd_check(param_get, param_set, h, rtol=0.08, atol=2e-3, name=""):
    """Compare AD grad vs central differences on a scalar parameter."""
    scene = _scene()

    def loss_of(v):
        return _loss_fb(param_set(scene, v))

    v0 = param_get(scene)
    g_ad = jax.grad(loss_of)(v0)
    g_fd = (loss_of(v0 + h) - loss_of(v0 - h)) / (2 * h)
    g_ad, g_fd = float(g_ad), float(g_fd)
    assert np.isfinite(g_ad) and np.isfinite(g_fd), name
    if abs(g_fd) < 5 * atol:  # tiny/zero gradient: absolute check
        assert abs(g_ad - g_fd) < 10 * atol, f"{name}: ad={g_ad} fd={g_fd}"
    else:
        assert abs(g_ad - g_fd) <= rtol * abs(g_fd) + atol, f"{name}: ad={g_ad} fd={g_fd}"


class TestSceneGradients:
    def test_sphere_center_z(self):
        _fd_check(
            lambda s: s.spheres.center[0, 2],
            lambda s, v: s._replace(spheres=s.spheres._replace(center=s.spheres.center.at[0, 2].set(v))),
            h=2e-3,
            name="center_z",
        )

    def test_sphere_radius(self):
        _fd_check(
            lambda s: s.spheres.radius[0],
            lambda s, v: s._replace(spheres=s.spheres._replace(radius=s.spheres.radius.at[0].set(v))),
            h=2e-3,
            name="radius",
        )

    def test_albedo(self):
        _fd_check(
            lambda s: s.materials.albedo[0, 0],
            lambda s, v: s._replace(materials=s.materials._replace(albedo=s.materials.albedo.at[0, 0].set(v))),
            h=1e-3,
            name="albedo",
        )

    def test_emit(self):
        _fd_check(
            lambda s: s.materials.emit[3, 1],
            lambda s, v: s._replace(materials=s.materials._replace(emit=s.materials.emit.at[3, 1].set(v))),
            h=1e-2,
            name="emit",
        )

    def test_metal_fuzz(self):
        _fd_check(
            lambda s: s.materials.fuzz[1],
            lambda s, v: s._replace(materials=s.materials._replace(fuzz=s.materials.fuzz.at[1].set(v))),
            h=2e-3,
            name="fuzz",
        )

    def test_dielectric_absorption(self):
        _fd_check(
            lambda s: s.materials.absorption[2, 1],
            lambda s, v: s._replace(materials=s.materials._replace(absorption=s.materials.absorption.at[2, 1].set(v))),
            h=2e-3,
            name="absorption",
        )

    def test_camera_origin(self):
        scene = _scene()
        cam = _cam()

        def loss_of(v):
            c = cam._replace(origin=cam.origin.at[0].set(v))
            # the viewport basis depends on origin too — rebuild from scratch
            c2 = C.build_camera_data(
                jnp.stack([v, cam.origin[1], cam.origin[2]]),
                [0.0, 0.0, 1.0], W, H, 55.0, background=(0.05, 0.07, 0.1),
            )
            return _loss_fb(scene, c2)

        v0 = cam.origin[0]
        g_ad = float(jax.grad(loss_of)(v0))
        h = 2e-3
        g_fd = float((loss_of(v0 + h) - loss_of(v0 - h)) / (2 * h))
        assert np.isfinite(g_ad)
        assert abs(g_ad - g_fd) <= 0.1 * abs(g_fd) + 5e-3, f"ad={g_ad} fd={g_fd}"

    def test_full_scene_pytree_grads_finite(self):
        scene = _scene()
        _, grads = jax.value_and_grad(_loss_fb, allow_int=True)(scene)
        for leaf in jax.tree_util.tree_leaves(grads):
            if jnp.issubdtype(leaf.dtype, jnp.floating):
                assert np.isfinite(np.asarray(leaf)).all()


def _textured(scene):
    """`scene` with its first material (sphere 0) textured."""
    g = np.random.default_rng(5)
    tex = g.uniform(0.2, 1.0, size=(1, 40, 56, 3)).astype(np.float32)
    tex_id = np.asarray(scene.materials.tex_id).copy()
    tex_id[0] = 0
    return scene._replace(
        textures=jnp.asarray(tex),
        materials=scene.materials._replace(tex_id=jnp.asarray(tex_id)),
    )


def _with(scene, group, field, idx, v):
    sub = getattr(scene, group)
    return scene._replace(**{group: sub._replace(**{field: getattr(sub, field).at[idx].set(v)})})


# A bright sky lights every surface, so each leaf moves the loss well
# above the f32 resolution of a central difference.
SKY = (0.8, 0.9, 1.0)


def _sky_cam(origin_x=5.0):
    return C.build_camera_data(
        jnp.stack([jnp.float32(origin_x), jnp.float32(-6.0), jnp.float32(3.0)]),
        [0.0, 0.0, 1.0], W, H, 55.0, background=SKY,
    )


def _origin_x(scene, v):
    return scene, _sky_cam(v)


# name -> (value at the base scene, (scene, v) -> (scene, cam), FD step)
PROBES = {
    "center_z": (1.0, lambda s, v: (_with(s, "spheres", "center", (0, 2), v), None), 2e-3),
    "radius": (1.0, lambda s, v: (_with(s, "spheres", "radius", 0, v), None), 2e-3),
    "camera_origin": (5.0, _origin_x, 2e-3),
    "albedo": (0.7, lambda s, v: (_with(s, "materials", "albedo", (0, 0), v), None), 1e-3),
    "emit": (5.0, lambda s, v: (_with(s, "materials", "emit", (3, 1), v), None), 1e-2),
    "absorption": (0.5, lambda s, v: (_with(s, "materials", "absorption", (2, 1), v), None), 2e-3),
    # a direction in texture space: every texel scaled by (1 + v)
    "texture": (0.0, lambda s, v: (s._replace(textures=s.textures * (1.0 + v)), None), 1e-3),
}
# Under a uniform sky, geometry moves the image only through texture
# coordinates (and silhouettes, which have no derivative), so geometry
# and texture probes run on the textured scene.
FD_CASES = (
    [(p, v) for p in ("center_z", "radius", "camera_origin", "texture")
     for v in ("textured", "textured_rr")]
    + [(p, v) for p in ("albedo", "emit", "absorption")
       for v in ("rr", "textured", "textured_rr")]
)


def _fd_case(probe, textured, rr_start):
    v0, set_v, h = PROBES[probe]
    scene = _textured(_scene()) if textured else _scene()

    def loss_of(v):
        s, cam = set_v(scene, v)
        fb = renderer.render_frame(s, cam or _sky_cam(), W, H, spp=SPP, max_depth=DEPTH,
                                   chunk=W * H, rr_start=rr_start)
        return jnp.sum(fb * fb) / (W * H * SPP)

    v0 = jnp.float32(v0)
    g_ad = float(jax.grad(loss_of)(v0))
    g_fd = float((loss_of(v0 + h) - loss_of(v0 - h)) / (2 * h))
    return g_ad, g_fd


@pytest.mark.parametrize("probe,variant", FD_CASES)
def test_ad_matches_finite_differences(probe, variant):
    """jax.grad against central differences for each differentiable leaf,
    with Russian roulette on and on a textured scene. At these parameters
    no discrete decision (hit, RNG gate, roulette kill) flips within
    +-h, so both see the same smooth branch. Every case has a gradient
    well above the f32 resolution of the difference (~1e-4)."""
    g_ad, g_fd = _fd_case(probe, textured="textured" in variant,
                          rr_start=1 if variant.endswith("rr") else None)
    atol = 5e-4
    assert abs(g_fd) > 5 * atol, f"gradient too small to check: fd={g_fd}"
    assert abs(g_ad - g_fd) <= 0.08 * abs(g_fd) + atol, f"ad={g_ad} fd={g_fd}"


class TestMaskedBranchNaN:
    def test_refract_grad_finite_at_exact_grazing(self):
        """ir=1 + grazing incidence makes refract's sqrt argument exactly
        0; the masked-out dielectric branch then multiplies a REAL zero
        cotangent into the infinite sqrt derivative (0*inf = NaN), which
        poisoned every geometry gradient at high ray counts until the
        gradient-safe sqrt. Pin the mechanism directly."""
        from tracer.core import vec

        uv = jnp.asarray([[1.0, 0.0, 0.0]])  # perpendicular to n: grazing
        n = jnp.asarray([[0.0, 0.0, 1.0]])

        def f(ir):
            out = vec.refract(uv, n, ir)
            # masked-out consumer: the where VJP sends a real zero
            # cotangent through refract
            masked = jnp.where(jnp.zeros((1, 1), bool), out, 0.0)
            return jnp.sum(masked) + 0.0 * jnp.sum(out)

        g = jax.grad(f)(jnp.float32(1.0))
        assert np.isfinite(float(g)), g

    @pytest.mark.parametrize("intersector", ["fast", "brute"])
    def test_tangent_ray_grad_finite(self, intersector):
        """A ray tangent to a sphere has discriminant exactly 0, where
        sqrt' is infinite; the non-winning roots get a zero cotangent, and
        0 * inf poisoned the sphere gradient (seen at 1080x720 on the GPU)."""
        from tracer.render import hit as hit_mod
        from tracer.render import hit_fast

        spheres = T.make_spheres([[0.0, 0.0, 0.0]], [1.0], [0])
        planes = T.make_planes([T.QUAD], [[-5, -5, -3]], [[10, 0, 0]], [[0, 10, 0]], [0])
        mats = T.make_materials([T.LAMBERTIAN], [0], [1], [[0, 0, 0]],
                                [[0.5, 0.5, 0.5]], [[0, 0, 0]], [-1])
        scene = T.Scene(spheres, planes, mats, None, None)
        o = jnp.array([[1.0, 0.0, 5.0], [0.3, 0.2, 5.0]])  # ray 0: disc == 0
        d = jnp.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
        hit_fn = hit_fast.hit_scene_fast if intersector == "fast" else hit_mod.hit_scene_brute

        def f(center):
            s = scene._replace(spheres=scene.spheres._replace(center=center))
            rec = hit_fn(s, o, d)
            return jnp.sum(rec.point) + jnp.sum(rec.normal)

        assert np.isfinite(np.asarray(jax.grad(f)(spheres.center))).all()

    def test_length_grad_finite_at_zero(self):
        from tracer.core import vec

        def f(v):
            return jnp.sum(jnp.where(False, vec.length(v), 0.0))

        g = jax.grad(f)(jnp.zeros((4, 3), jnp.float32))
        assert np.isfinite(np.asarray(g)).all()


class TestChunkedGradients:
    """tracer.opt.grads.l2_grads_deep: one forward frame for the loss, then
    the VJP of each spp chunk's render on the fixed frame cotangent. The
    chunk sums must equal jax.grad of the same loss up to f32 addition
    order, for any chunking."""

    def _cmp(self, got, want, rel=1e-5):
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            if jnp.issubdtype(a.dtype, jnp.floating):
                an, bn = np.asarray(a), np.asarray(b)
                tol = rel * max(1.0, float(np.abs(bn).max()))
                np.testing.assert_allclose(an, bn, atol=tol, rtol=1e-4)

    def test_chunked_matches_full_tape(self):
        """Two chunks of 2 spp against jax.grad of the one-shot render."""
        from tracer.opt import grads

        scene, spp = _scene(), 4
        g = np.random.default_rng(7)
        target = g.uniform(0, 1, size=(H, W, 3)).astype(np.float32)

        def loss(scene, cam):
            fb = renderer.render_frame(scene, cam, W, H, spp=spp, max_depth=DEPTH)
            return jnp.mean((fb / spp - target) ** 2)

        l_full, (gs_full, gc_full) = jax.value_and_grad(
            loss, argnums=(0, 1), allow_int=True)(scene, _cam())
        l_ch, gs_ch, gc_ch = grads.l2_grads_deep(
            scene, _cam(), target, W, H, spp, DEPTH, spp_chunk=2)
        np.testing.assert_allclose(float(l_ch), float(l_full), rtol=1e-6)
        self._cmp((gs_ch, gc_ch), (gs_full, gc_full))

    def test_l2_grads_deep_multi_segment(self):
        """Depth 10 with one-sample chunks: finite loss, finite and
        nonzero gradients on scene and camera (the reference's real
        max_depth=50 runs on the GPU in chip_smoke.py)."""
        from tracer.opt import grads

        scene = _scene()
        spp, depth = 2, 10
        target = np.zeros((H, W, 3), np.float32)

        loss, gs, gc = grads.l2_grads_deep(
            scene, _cam(), target, W, H, spp, depth, spp_chunk=1)
        assert np.isfinite(float(loss))
        leaves = [np.asarray(x) for x in
                  jax.tree_util.tree_leaves(gs) + jax.tree_util.tree_leaves(gc)
                  if jnp.issubdtype(x.dtype, jnp.floating)]
        assert all(np.isfinite(a).all() for a in leaves)
        assert any(np.abs(a).max() > 0 for a in leaves)

    @pytest.mark.parametrize("variant", ["plain", "textured", "rr"])
    @pytest.mark.parametrize("spp_chunk", [1, 2, 4])
    def test_chunked_matches_unchunked(self, spp_chunk, variant):
        from tracer.opt import grads

        scene = _textured(_scene()) if variant == "textured" else _scene()
        rr = 1 if variant == "rr" else None
        spp = 4
        target = np.full((H, W, 3), 0.2, np.float32)
        l_one, gs_one, gc_one = grads.l2_grads_deep(
            scene, _cam(), target, W, H, spp, DEPTH, rr_start=rr)
        l_ch, gs_ch, gc_ch = grads.l2_grads_deep(
            scene, _cam(), target, W, H, spp, DEPTH, spp_chunk=spp_chunk,
            rr_start=rr)
        np.testing.assert_allclose(float(l_ch), float(l_one), rtol=1e-6)
        self._cmp((gs_ch, gc_ch), (gs_one, gc_one))
        if variant == "textured":
            assert float(np.abs(np.asarray(gs_ch.textures)).max()) > 0.0

    def test_spp_chunk_must_divide_spp(self):
        from tracer.opt import grads

        with pytest.raises(ValueError, match="multiple"):
            grads.l2_grads_deep(_scene(), _cam(), np.zeros((H, W, 3), np.float32),
                                W, H, 4, 2, spp_chunk=3)
