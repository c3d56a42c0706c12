"""L1 RNG: stateless counter-based wang_hash streams, SIMD-shaped.

The reference (include/random_utils.h) threads a single mutable
`unsigned int seed` through every sample: `random_float` hashes the seed
in place, and `random_in_unit_sphere` draws in a *rejection loop* of
unbounded length. An unbounded, data-dependent loop cannot map onto a
vector machine, so the batched design replaces rejection sampling
with *exact analytic* samplers that consume a fixed number of hash
advances per call while producing the identical probability
distributions:

- uniform on the unit sphere: (z, phi) parameterisation, 2 advances
  (same distribution as `random_unit_vector`, random_utils.h:34);
- uniform in the unit ball: sphere sample times cbrt(u), 3 advances
  (same distribution as `random_in_unit_sphere`, random_utils.h:25-32).

`wang_hash` and `random_float` themselves are bit-exact ports
(random_utils.h:7-23): integer ops are exactly reproducible across
backends, so camera-ray jitter (which performs no rejection) matches the
reference binary bit-for-bit. Parity for bounce directions is defined at
the distribution/image level (SURVEY.md section 7, hard part (c)).

Every function is pure: it takes a uint32 seed array of any shape and
returns `(new_seed, value)`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from tracer.core import vec

_U32 = jnp.uint32


def wang_hash(seed: jnp.ndarray) -> jnp.ndarray:
    """Wang integer mix, bit-exact vs reference include/random_utils.h:7-14."""
    seed = jnp.asarray(seed, _U32)
    seed = (seed ^ _U32(61)) ^ (seed >> _U32(16))
    seed = seed * _U32(9)
    seed = seed ^ (seed >> _U32(4))
    seed = seed * _U32(0x27D4EB2D)
    seed = seed ^ (seed >> _U32(15))
    return seed


def random_float(seed: jnp.ndarray):
    """Advance the seed and map to [0, 1). reference: random_utils.h:16-19.

    Returns `(new_seed, u)` with `u = new_seed / 2**32` in float32.
    """
    seed = wang_hash(seed)
    return seed, seed.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)


def random_float_range(seed: jnp.ndarray, lo: float, hi: float):
    """reference: random_utils.h:21-23."""
    seed, u = random_float(seed)
    return seed, lo + (hi - lo) * u


def random_unit_vector(seed: jnp.ndarray):
    """Uniform direction on the unit sphere; 2 seed advances.

    Distribution-identical to the reference's normalize-of-rejection
    sample (random_utils.h:34) without the unbounded loop: z uniform in
    [-1, 1), phi uniform in [0, 2pi) gives exactly the uniform sphere
    measure.
    """
    seed, u1 = random_float(seed)
    seed, u2 = random_float(seed)
    z = 2.0 * u1 - 1.0
    phi = (2.0 * jnp.pi) * u2
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    d = jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)
    return seed, d


def random_in_unit_sphere(seed: jnp.ndarray):
    """Uniform point in the open unit ball; 3 seed advances.

    Distribution-identical to the rejection loop at random_utils.h:25-32:
    uniform direction scaled by cbrt(u) (volume-uniform radius).
    """
    seed, d = random_unit_vector(seed)
    seed, u = random_float(seed)
    r = jnp.cbrt(u)
    return seed, d * r[..., None]


def random_in_hemisphere(normal: jnp.ndarray, seed: jnp.ndarray):
    """Uniform direction in the hemisphere around `normal`; 2 advances.

    reference: random_utils.h:36-42 (unit sphere sample, sign-flipped
    against the normal).
    """
    seed, d = random_unit_vector(seed)
    flip = jnp.where(vec.dot(d, normal) > 0.0, 1.0, -1.0)
    return seed, d * flip[..., None]


MAX_REJECTION_TRIES = 16  # acceptance ~0.524/try -> P(miss all) ~ 3e-5


def random_in_unit_sphere_rejection(seed: jnp.ndarray, max_tries: int = MAX_REJECTION_TRIES):
    """Reference-stream rejection sampling (random_utils.h:25-32).

    Emulates the reference's unbounded `while (true)` loop with a bounded
    unroll: each try draws 3 uniforms in [-1, 1); a lane stops advancing
    its seed once it accepts, so the per-lane wang_hash stream matches
    the reference binary exactly for lanes accepting within `max_tries`
    (P(miss) ~ 0.48^16 per call). Never-accepted lanes keep the last
    candidate scaled into the ball — a <=3e-5 statistical tail.

    Returns (new_seed, point).
    """
    def body(_, carry):
        seed, found, val = carry
        s, x = random_float_range(seed, -1.0, 1.0)
        s, y = random_float_range(s, -1.0, 1.0)
        s, z = random_float_range(s, -1.0, 1.0)
        cand = jnp.stack([x, y, z], axis=-1)
        ok = vec.length_squared(cand) < 1.0
        take = ok & ~found
        val = jnp.where(take[..., None], cand, val)
        # lanes that already accepted stop consuming draws
        seed = jnp.where(found, seed, s)
        return seed, found | ok, val

    # derive carry inits from `seed` (not fresh constants) so their
    # varying-manual-axes types match under shard_map
    found0 = ~(seed == seed)  # all-False
    val0 = jnp.zeros_like(seed, dtype=jnp.float32, shape=jnp.shape(seed) + (3,))
    seed, found, val = jax.lax.fori_loop(0, max_tries, body, (seed, found0, val0))
    # tail fallback: pull the last candidate inside the ball
    norm = jnp.sqrt(jnp.maximum(vec.length_squared(val), 1e-12))
    val = jnp.where(found[..., None], val, val / jnp.maximum(norm, 1.0)[..., None] * 0.99)
    return seed, val


def random_unit_vector_ref(seed: jnp.ndarray):
    """reference random_utils.h:34: unit_vector(random_in_unit_sphere)."""
    seed, p = random_in_unit_sphere_rejection(seed)
    return seed, vec.unit_vector(p, eps=1e-24)


def random_in_hemisphere_ref(normal: jnp.ndarray, seed: jnp.ndarray):
    """reference random_utils.h:36-42 with the true rejection stream."""
    seed, d = random_unit_vector_ref(seed)
    flip = jnp.where(vec.dot(d, normal) > 0.0, 1.0, -1.0)
    return seed, d * flip[..., None]


def pixel_seed(i: jnp.ndarray, j: jnp.ndarray, width: int, reference_quirk: bool = True):
    """Per-pixel base seed.

    The reference seeds with `wang_hash(i * width + j)` — note `i*width+j`
    rather than `j*width+i` (src/camera.cu:25), which collides for
    non-square images. `reference_quirk=True` (default) reproduces it for
    binary parity; False uses the corrected row-major indexing
    (SURVEY.md section 7, hard part (e)).
    """
    i = jnp.asarray(i, _U32)
    j = jnp.asarray(j, _U32)
    w = _U32(width)
    lin = i * w + j if reference_quirk else j * w + i
    return wang_hash(lin)


def sample_seed(base_pixel_seed: jnp.ndarray, s: jnp.ndarray) -> jnp.ndarray:
    """Per-sample seed: `wang_hash(base + s)`. reference: src/camera.cu:28."""
    return wang_hash(base_pixel_seed + jnp.asarray(s, _U32))
