"""Bilinear texture sampling matching the reference CPU sampler.

reference `tex2D_cpu` (include/materials.h:20-51): wrap addressing via
u - floor(u), v flipped (py = (1-v)*H), truncation to texel, neighbor
wrap with modulo, bilinear blend. The CUDA HW sampler (main.cu:41) is only
approximately equal to this (9-bit fractional weights); per SURVEY.md §7
hard part (f) the CPU sampler defines parity.

The batched form is a vectorized gather over a `[T, H, W, 3]` texture
stack; `tex_id` selects the layer.
"""

from __future__ import annotations

import jax.numpy as jnp


def sample_bilinear(textures: jnp.ndarray, tex_id: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Sample `textures[tex_id]` at (u, v) with tex2D_cpu semantics.

    Args:
      textures: `[T, H, W, 3]` float32 stack (all layers same size).
      tex_id: `[R]` int32; negative ids are clamped to 0 (callers mask the
        result out for untextured materials).
      u, v: `[R]` float32.

    Returns `[R, 3]` float32.
    """
    _, height, width, _ = textures.shape
    tid = jnp.maximum(tex_id, 0)

    u = u - jnp.floor(u)  # materials.h:23
    v = v - jnp.floor(v)  # materials.h:24

    px = u * width  # materials.h:26
    py = (1.0 - v) * height  # materials.h:27 (v flip)

    x0 = px.astype(jnp.int32)  # trunc == floor for px >= 0
    y0 = py.astype(jnp.int32)
    # Guard the u==0 -> px==W edge (float32 rounding can land exactly on W).
    x0 = jnp.clip(x0, 0, width - 1)
    y0 = jnp.clip(y0, 0, height - 1)
    x1 = (x0 + 1) % width  # materials.h:30
    y1 = (y0 + 1) % height  # materials.h:31

    dx = (px - x0.astype(px.dtype))[..., None]
    dy = (py - y0.astype(py.dtype))[..., None]

    c00 = textures[tid, y0, x0]
    c10 = textures[tid, y0, x1]
    c01 = textures[tid, y1, x0]
    c11 = textures[tid, y1, x1]

    top = c00 * (1.0 - dx) + c10 * dx
    bot = c01 * (1.0 - dx) + c11 * dx
    return top * (1.0 - dy) + bot * dy
