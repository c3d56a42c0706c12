"""Scene pytrees: structs-of-arrays replacing the reference's AoS device pointers.

The reference stores the scene as arrays of 16-byte-aligned structs behind
raw device pointers (`SceneData`, include/scene.h:9-21). The JAX
layout is a pytree of flat `[N, ...]` arrays: every per-primitive field is
its own array so intersection math vectorizes over the primitive axis on
the device and the whole pytree shards/replicates via `jax.sharding`.

All pytrees are NamedTuples (automatically registered with JAX), all
continuous fields are float32 and differentiable; index/type fields are
int32 and act as static-per-primitive codes selected with masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

# Plane interior types — reference include/plane.h:7 (enum PlaneType).
QUAD = 0
ELLIPSE = 1
TRIANGLE = 2

# Material types — reference include/materials.h:12 (enum MaterialType).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2
DIFFUSE_LIGHT = 3

# Reference include/interval.h:3 (kInfinity).
K_INFINITY = 1e32


class Spheres(NamedTuple):
    """SoA of reference `SphereData` (include/sphere.h:8-14)."""

    center: jnp.ndarray  # [S, 3] f32
    radius: jnp.ndarray  # [S] f32
    material_idx: jnp.ndarray  # [S] i32


class Planes(NamedTuple):
    """SoA of reference `PlaneData` (include/plane.h:9-28).

    `normal`, `d` and `w` are precomputed from (base, u, v) exactly like
    the PlaneData constructor (plane.h:19-28): n = cross(u, v),
    normal = n/|n|, d = normal·base, w = n/(n·n).
    """

    ptype: jnp.ndarray  # [P] i32 in {QUAD, ELLIPSE, TRIANGLE}
    base: jnp.ndarray  # [P, 3] f32
    u: jnp.ndarray  # [P, 3] f32
    v: jnp.ndarray  # [P, 3] f32
    normal: jnp.ndarray  # [P, 3] f32
    d: jnp.ndarray  # [P] f32
    w: jnp.ndarray  # [P, 3] f32
    material_idx: jnp.ndarray  # [P] i32


class Materials(NamedTuple):
    """SoA of reference `MaterialData` (include/materials.h:53-62).

    `tex_id` replaces the CUDA texture object handle: -1 means no texture,
    >= 0 indexes `Scene.textures`.
    """

    mtype: jnp.ndarray  # [M] i32 in {LAMBERTIAN, METAL, DIELECTRIC, DIFFUSE_LIGHT}
    fuzz: jnp.ndarray  # [M] f32
    ir: jnp.ndarray  # [M] f32
    absorption: jnp.ndarray  # [M, 3] f32
    albedo: jnp.ndarray  # [M, 3] f32
    emit: jnp.ndarray  # [M, 3] f32
    tex_id: jnp.ndarray  # [M] i32


class BVHArrays(NamedTuple):
    """Flat preorder BVH (reference include/bvh.h:7-17, bvh_builder.h:52-120).

    Leaves: left == -1, right = primitive index, kind = 0 (sphere) / 1 (plane).
    Internal: left/right = child node indices, kind = -1, and `axis` stores
    the real split axis (the reference buggily overloads `type` as the axis,
    bvh.h:52 vs bvh_builder.h:94 — we store it properly per SURVEY.md L3).
    """

    box_min: jnp.ndarray  # [N, 3] f32
    box_max: jnp.ndarray  # [N, 3] f32
    left: jnp.ndarray  # [N] i32
    right: jnp.ndarray  # [N] i32
    kind: jnp.ndarray  # [N] i32
    axis: jnp.ndarray  # [N] i32


class Scene(NamedTuple):
    """Replicated scene pytree (analog of reference SceneData, scene.h:9-21)."""

    spheres: Spheres
    planes: Planes
    materials: Materials
    # [T, Ht, Wt, 3] float32 stack of textures, or None. The reference holds
    # one optional floor texture (main.cu:16-60); we generalise to a stack.
    textures: Optional[jnp.ndarray]
    bvh: Optional[BVHArrays]

    @property
    def num_spheres(self) -> int:
        return self.spheres.center.shape[0]

    @property
    def num_planes(self) -> int:
        return self.planes.base.shape[0]

    @property
    def num_materials(self) -> int:
        return self.materials.albedo.shape[0]


def make_spheres(centers, radii, material_idx) -> Spheres:
    return Spheres(
        center=jnp.asarray(centers, jnp.float32).reshape(-1, 3),
        radius=jnp.asarray(radii, jnp.float32).reshape(-1),
        material_idx=jnp.asarray(material_idx, jnp.int32).reshape(-1),
    )


def make_planes(ptype, base, u, v, material_idx) -> Planes:
    """Precompute normal/d/w exactly like PlaneData's ctor (plane.h:19-28)."""
    base = jnp.asarray(base, jnp.float32).reshape(-1, 3)
    u = jnp.asarray(u, jnp.float32).reshape(-1, 3)
    v = jnp.asarray(v, jnp.float32).reshape(-1, 3)
    n = jnp.cross(u, v)
    nn = jnp.sum(n * n, axis=-1)
    normal = n / jnp.sqrt(nn)[..., None]
    d = jnp.sum(normal * base, axis=-1)
    w = n / nn[..., None]
    return Planes(
        ptype=jnp.asarray(ptype, jnp.int32).reshape(-1),
        base=base,
        u=u,
        v=v,
        normal=normal,
        d=d,
        w=w,
        material_idx=jnp.asarray(material_idx, jnp.int32).reshape(-1),
    )


def make_materials(mtype, fuzz, ir, absorption, albedo, emit, tex_id) -> Materials:
    return Materials(
        mtype=jnp.asarray(mtype, jnp.int32).reshape(-1),
        fuzz=jnp.asarray(fuzz, jnp.float32).reshape(-1),
        ir=jnp.asarray(ir, jnp.float32).reshape(-1),
        absorption=jnp.asarray(absorption, jnp.float32).reshape(-1, 3),
        albedo=jnp.asarray(albedo, jnp.float32).reshape(-1, 3),
        emit=jnp.asarray(emit, jnp.float32).reshape(-1, 3),
        tex_id=jnp.asarray(tex_id, jnp.int32).reshape(-1),
    )


def empty_spheres() -> Spheres:
    return make_spheres(jnp.zeros((0, 3)), jnp.zeros((0,)), jnp.zeros((0,), jnp.int32))


def empty_planes() -> Planes:
    z3 = jnp.zeros((0, 3), jnp.float32)
    z = jnp.zeros((0,), jnp.float32)
    zi = jnp.zeros((0,), jnp.int32)
    return Planes(ptype=zi, base=z3, u=z3, v=z3, normal=z3, d=z, w=z3, material_idx=zi)
