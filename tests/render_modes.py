"""Shared scenes and render modes for the intersector/oracle parity tests.

`full_scene` is a tiny scene exercising every material and plane type;
`MODES` lists every render mode the CLI exposes, each as the keyword
arguments of `render` (the vectorized renderer) and `render_oracle`
(the scalar NumPy oracle, tests/oracle.py).
"""

import numpy as np
import jax
import jax.numpy as jnp

import oracle
from tracer.render import camera as C
from tracer.render import renderer
from tracer.scene import types as T

W, H, SPP, DEPTH = 16, 12, 2, 5

# name -> overrides of the defaults in `render`
MODES = {
    "default": {},
    "no_quirk": dict(reference_quirk=False),
    "rr": dict(rr_start=1, depth=6),
    "stratify": dict(stratify=True, spp=4),
    "ref_rng": dict(rng_mode="reference"),
    "small_texture": dict(texture=(8, 8)),
    "large_texture": dict(texture=(1330, 2000)),  # the reference floor's size
    "untextured": dict(texture=None),
    "sphere_only": dict(spheres_only=True),
    "ragged_pixels": dict(w=13, h=7, chunk=32),  # 91 px: not a multiple of chunk
    "chunk_16": dict(chunk=16),
    "chunk_64": dict(chunk=64),
    "sample_start": dict(sample_start=3),
}


def full_scene(texture=(8, 8), spheres_only=False):
    """(Scene pytree, oracle scene dict); `texture` is the floor texture's
    (height, width) or None."""
    g = np.random.default_rng(11)
    tex = None
    if texture is not None:
        tex = g.uniform(0.2, 1.0, size=(1,) + tuple(texture) + (3,)).astype(np.float32)

    sphere_center = np.array(
        [[0.0, 0.0, 1.0], [2.2, 0.0, 1.0], [-2.2, 0.0, 1.0], [0.0, 2.5, 4.0]], np.float32
    )
    sphere_radius = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
    sphere_mat = np.array([0, 1, 2, 3], np.int32)  # lam, metal, dielectric, light

    # floor quad (textured metal), a triangle, an ellipse
    plane_base = np.array([[-8, -8, 0], [3, -2, 0.5], [-5, -2, 0.5]], np.float32)
    plane_u = np.array([[16, 0, 0], [2, 0, 0], [2, 0, 0]], np.float32)
    plane_v = np.array([[0, 16, 0], [0, 0, 2], [0, 0, 2]], np.float32)
    plane_type = np.array([T.QUAD, T.TRIANGLE, T.ELLIPSE], np.int32)
    plane_mat = np.array([4, 0, 0], np.int32)

    mats = dict(
        mtype=np.array([T.LAMBERTIAN, T.METAL, T.DIELECTRIC, T.DIFFUSE_LIGHT, T.METAL], np.int32),
        fuzz=np.array([0.0, 0.3, 0.0, 0.0, 0.1], np.float32),
        ir=np.array([1.0, 1.0, 1.5, 1.0, 1.0], np.float32),
        absorption=np.array(
            [[0, 0, 0], [0, 0, 0], [0.3, 0.5, 0.1], [0, 0, 0], [0, 0, 0]], np.float32
        ),
        albedo=np.array(
            [[0.7, 0.3, 0.3], [0.8, 0.8, 0.9], [1, 1, 1], [0, 0, 0], [0.9, 0.9, 0.9]], np.float32
        ),
        emit=np.array([[0, 0, 0], [0, 0, 0], [0, 0, 0], [6, 5, 4], [0, 0, 0]], np.float32),
        tex_id=np.array([-1, -1, -1, -1, 0 if tex is not None else -1], np.int32),
    )

    if spheres_only:
        planes = T.make_planes(
            np.zeros((0,), np.int32), np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32),
            np.zeros((0,), np.int32),
        )
        n_planes = 0
    else:
        planes = T.make_planes(plane_type, plane_base, plane_u, plane_v, plane_mat)
        n_planes = 3
    scene_jax = T.Scene(
        spheres=T.make_spheres(sphere_center, sphere_radius, sphere_mat),
        planes=planes,
        materials=T.make_materials(**mats),
        textures=jnp.asarray(tex) if tex is not None else None,
        bvh=None,
    )

    planes_np = []
    pl = scene_jax.planes
    for k in range(n_planes):
        planes_np.append(
            {
                "ptype": int(plane_type[k]),
                "base": plane_base[k],
                "u": plane_u[k],
                "v": plane_v[k],
                "normal": np.asarray(pl.normal)[k],
                "d": np.asarray(pl.d)[k],
                "w": np.asarray(pl.w)[k],
                "mat": int(plane_mat[k]),
            }
        )
    scene_np = {
        "sphere_center": sphere_center,
        "sphere_radius": sphere_radius,
        "sphere_mat": sphere_mat,
        "planes": planes_np,
        "materials": [
            {k: (v[m] if v.ndim else v) for k, v in mats.items()} for m in range(5)
        ],
        "textures": tex,
    }
    return scene_jax, scene_np


def cameras(width, height):
    """(CameraData, oracle camera dict) looking at the full scene."""
    cam = C.build_camera_data(
        origin=[5.0, -6.0, 3.0],
        look_at=[0.0, 0.0, 1.0],
        width=width,
        height=height,
        vfov=55.0,
        background=(0.05, 0.07, 0.1),
    )
    cam_np = {
        "origin": np.asarray(cam.origin),
        "pixel00_loc": np.asarray(cam.pixel00_loc),
        "pixel_delta_u": np.asarray(cam.pixel_delta_u),
        "pixel_delta_v": np.asarray(cam.pixel_delta_v),
        "background": np.asarray(cam.background),
    }
    return cam, cam_np


def _settings(mode):
    o = dict(w=W, h=H, spp=SPP, depth=DEPTH, chunk=64, texture=(8, 8),
             spheres_only=False, reference_quirk=True, rng_mode="fixed",
             stratify=False, rr_start=None, sample_start=0)
    o.update(MODES[mode])
    return o


_render_pixels = jax.jit(
    renderer.render_pixels,
    static_argnames=("spp", "max_depth", "intersector", "chunk", "rng_mode",
                     "stratify", "rr_start"),
)


def render(mode, intersector="fast"):
    """Raw sample sums [H, W, 3] of `mode` from the vectorized renderer."""
    o = _settings(mode)
    scene, _ = full_scene(o["texture"], o["spheres_only"])
    cam, _ = cameras(o["w"], o["h"])
    i, j, base = renderer.pixel_grid(o["w"], o["h"], o["reference_quirk"])
    fb = _render_pixels(
        scene, cam, i, j, base, spp=o["spp"], max_depth=o["depth"], intersector=intersector,
        chunk=o["chunk"], sample_start=o["sample_start"], rng_mode=o["rng_mode"],
        stratify=o["stratify"], rr_start=o["rr_start"],
    )
    return np.asarray(fb).reshape(o["h"], o["w"], 3)


def render_oracle(mode):
    """The same frame from the scalar oracle."""
    o = _settings(mode)
    _, scene_np = full_scene(o["texture"], o["spheres_only"])
    _, cam_np = cameras(o["w"], o["h"])
    return oracle.render(
        scene_np, cam_np, o["w"], o["h"], spp=o["spp"], max_depth=o["depth"],
        reference_quirk=o["reference_quirk"], rng_mode=o["rng_mode"],
        sample_start=o["sample_start"], stratify=o["stratify"],
        rr_start=o["rr_start"],
    )


def assert_frames_agree(got, want, share=0.99, tol=1e-3, mean_rtol=1e-3):
    """f32 reassociation can flip an RNG gate or a razor-edge hit on rare
    samples: demand near-exact agreement on `share` of the pixels and a
    tight frame mean."""
    diff = np.abs(got - want).max(axis=-1)
    assert (diff < tol).mean() >= share, f"max diff {diff.max()}"
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=mean_rtol)
