"""Camera: look-at basis, viewport, and jittered primary-ray generation.

reference `Camera::build_camera_data` (src/camera.cu:171-196) and
`CameraData::get_ray` (include/camera.cuh:97-109). The camera is a pytree
of float32 arrays so every field is differentiable (origin, look_at, vfov
gradients flow through the basis and the ray directions).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from tracer.core import rng, vec

DEFAULT_VUP = (0.0, 0.0, 1.0)  # reference camera.cu:166 (vup = (0,0,1))
DEFAULT_VFOV = 60.0  # reference camera.cuh:132
DEFAULT_SPP = 300  # reference camera.cu:159
DEFAULT_MAX_DEPTH = 50  # reference camera.cu:160


class CameraData(NamedTuple):
    """Pytree analog of reference CameraData (camera.cuh:86-95)."""

    origin: jnp.ndarray  # [3]
    pixel00_loc: jnp.ndarray  # [3]
    pixel_delta_u: jnp.ndarray  # [3]
    pixel_delta_v: jnp.ndarray  # [3]
    background: jnp.ndarray  # [3]


def build_camera_data(
    origin,
    look_at,
    width: int,
    height: int,
    vfov=DEFAULT_VFOV,
    vup=DEFAULT_VUP,
    background=(0.0, 0.0, 0.0),
) -> CameraData:
    """reference src/camera.cu:171-196 (look-at basis + viewport)."""
    origin = jnp.asarray(origin, jnp.float32)
    look_at = jnp.asarray(look_at, jnp.float32)
    vup = jnp.asarray(vup, jnp.float32)
    vfov = jnp.asarray(vfov, jnp.float32)

    theta = vfov * (jnp.pi / 180.0)
    h = jnp.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = viewport_height * (float(width) / float(height))

    w = vec.unit_vector(origin - look_at)
    u = vec.unit_vector(vec.cross(vup, w))
    v = vec.cross(w, u)

    horizontal = viewport_width * u
    vertical = viewport_height * v

    pixel_delta_u = horizontal / width
    pixel_delta_v = -vertical / height  # note the sign (camera.cu:185)
    upper_left = origin - w - horizontal / 2.0 + vertical / 2.0
    pixel00_loc = upper_left + 0.5 * (pixel_delta_u + pixel_delta_v)

    return CameraData(
        origin=origin,
        pixel00_loc=pixel00_loc,
        pixel_delta_u=pixel_delta_u,
        pixel_delta_v=pixel_delta_v,
        background=jnp.asarray(background, jnp.float32),
    )


def get_rays(cam: CameraData, i, j, seed, sample_index=None, sqrt_spp: int = 0):
    """Jittered primary rays for pixel columns `i`, rows `j` (both [R]).

    reference camera.cuh:97-109: pixel center + uniform offset in
    [-0.5, 0.5]^2 of a pixel; direction is NOT normalized. Two RNG
    advances per ray, x before y. Returns (seed, origin[R,3], dir[R,3]).

    Stratified anti-aliasing (`sqrt_spp` > 0 with `sample_index` set):
    sample s lands in cell (s % k, s // k) of a k x k sub-pixel grid with
    the uniform jitter confined to the cell — same two RNG advances, so
    the rest of the stream is unchanged. The reference names its sample
    count sqrt_rays_per_pixel^2 but jitters uniformly; this realizes the
    stratification that name implies (off by default for parity).
    """
    fi = i.astype(jnp.float32)[..., None]
    fj = j.astype(jnp.float32)[..., None]
    pixel_center = cam.pixel00_loc + fi * cam.pixel_delta_u + fj * cam.pixel_delta_v

    seed, ox = rng.random_float(seed)
    seed, oy = rng.random_float(seed)
    if sqrt_spp and sample_index is not None:
        k = jnp.float32(sqrt_spp)
        s = jnp.asarray(sample_index, jnp.float32)
        cell_x = jnp.mod(s, k)
        cell_y = jnp.floor(s / k)
        offset_x = (cell_x + ox) / k - 0.5
        offset_y = (cell_y + oy) / k - 0.5
    else:
        offset_x = ox - 0.5
        offset_y = oy - 0.5

    pixel_sample = (
        pixel_center
        + offset_x[..., None] * cam.pixel_delta_u
        + offset_y[..., None] * cam.pixel_delta_v
    )
    origin = jnp.broadcast_to(cam.origin, pixel_sample.shape)
    return seed, origin, pixel_sample - origin


def camera_path_position(path, frame: jnp.ndarray, num_frames: int):
    """Sinusoidal cylindrical camera path, one frame.

    reference src/camera.cu:303-315: t = (n / num_frames) * 2pi;
    r/z sinusoidal, phi linear; returns (lookfrom[3], lookat[3]).
    `path` is a CameraPathParams (tracer.scene.params).
    """
    t = (jnp.asarray(frame, jnp.float32) / num_frames) * (2.0 * jnp.pi)
    r_c = path.rc0 + path.arc * jnp.sin(path.wrc * t + path.prc)
    z_c = path.zc0 + path.azc * jnp.sin(path.wzc * t + path.pzc)
    phi_c = path.phic0 + path.wc * t
    lookfrom = jnp.stack([r_c * jnp.cos(phi_c), r_c * jnp.sin(phi_c), z_c])

    r_n = path.rn0 + path.arn * jnp.sin(path.wrn * t + path.prn)
    z_n = path.zn0 + path.azn * jnp.sin(path.wzn * t + path.pzn)
    phi_n = path.phin0 + path.wn * t
    lookat = jnp.stack([r_n * jnp.cos(phi_n), r_n * jnp.sin(phi_n), z_n])
    return lookfrom, lookat


@partial(jax.jit, static_argnames=("path_tuple", "num_frames", "width", "height",
                                   "vfov", "background"))
def _camera_at_jit(path_tuple, frame, num_frames, width, height, vfov, background):
    from tracer.scene.params import CameraPathParams

    path = CameraPathParams(*path_tuple)
    lookfrom, lookat = camera_path_position(path, frame, num_frames)
    return build_camera_data(
        origin=lookfrom, look_at=lookat, width=width, height=height,
        vfov=vfov, background=background,
    )


def camera_at(path, frame, num_frames, width, height, vfov,
              background=(0.0, 0.0, 0.0)) -> CameraData:
    """Camera for animation frame `frame` in ONE dispatch.

    Fuses camera_path_position + build_camera_data under jit: the eager
    composition would dispatch ~100 tiny device ops per frame. Numerically
    identical math; the path params are passed as a static tuple so only
    the frame index is traced."""
    import dataclasses

    return _camera_at_jit(
        tuple(dataclasses.astuple(path)), frame, num_frames, width, height,
        float(vfov), tuple(background),
    )
