"""Scalar NumPy oracle renderer.

A deliberately slow, scalar re-implementation of the render algorithm —
the same role the reference's CPU renderer plays for its GPU kernel
(src/camera.cu:36-50 vs 17-34): identical seeds, identical math, a
different execution engine. The vectorized JAX renderer must match this
oracle pixel-for-pixel (modulo f32 reassociation).

Algorithm parity notes vs /root/reference:
- wang_hash / random_float streams: random_utils.h:7-19, bit-exact.
- fixed 8-draw scatter budget per bounce (tracer.materials.scatter):
  u_choice, hemi(z,phi), ball(z,phi,u), u_refl, u_rr — this is OUR
  convention (SURVEY.md §7(c)), shared by oracle and JAX renderer.
- intersection: sphere.h:24-53, plane.h:57-96, closed interval
  [1e-3, 1e30] (camera.cu:226).
- shading loop: camera.cu:218-288 with materials.h:70-140.
"""

from __future__ import annotations

import math

import numpy as np

F = np.float32
M32 = 0xFFFFFFFF
K_INF = F(1e32)


def wang_hash(seed: int) -> int:
    seed = ((seed ^ 61) ^ (seed >> 16)) & M32
    seed = (seed * 9) & M32
    seed = (seed ^ (seed >> 4)) & M32
    seed = (seed * 0x27D4EB2D) & M32
    seed = (seed ^ (seed >> 15)) & M32
    return seed


class Rng:
    def __init__(self, seed: int):
        self.seed = seed & M32

    def random_float(self) -> np.float32:
        self.seed = wang_hash(self.seed)
        return F(F(self.seed) * F(1.0 / 4294967296.0))

    def unit_vector(self):
        u1 = self.random_float()
        u2 = self.random_float()
        z = F(F(2.0) * u1 - F(1.0))
        phi = F(F(2.0 * np.pi) * u2)
        r = F(math.sqrt(max(0.0, 1.0 - float(z) * float(z))))
        return np.array([r * F(math.cos(phi)), r * F(math.sin(phi)), z], F)

    def in_unit_sphere(self):
        d = self.unit_vector()
        u = self.random_float()
        return (d * F(np.cbrt(u))).astype(F)

    def in_hemisphere(self, normal):
        d = self.unit_vector()
        if float(np.dot(d, normal)) > 0.0:
            return d
        return -d

    # --- reference-stream samplers (true rejection loops,
    #     random_utils.h:25-42) ------------------------------------------
    def in_unit_sphere_ref(self):
        while True:
            x = F(F(-1.0) + F(2.0) * self.random_float())
            y = F(F(-1.0) + F(2.0) * self.random_float())
            z = F(F(-1.0) + F(2.0) * self.random_float())
            cand = np.array([x, y, z], F)
            if float(np.dot(cand, cand)) < 1.0:
                return cand

    def unit_vector_ref(self):
        return _unit(self.in_unit_sphere_ref())

    def in_hemisphere_ref(self, normal):
        d = self.unit_vector_ref()
        if float(np.dot(d, normal)) > 0.0:
            return d
        return -d


def _unit(v):
    return (v / F(np.linalg.norm(v))).astype(F)


def _reflect(v, n):
    return (v - F(2.0) * F(np.dot(v, n)) * n).astype(F)


def _refract(uv, n, ratio):
    cos_theta = min(float(np.dot(-uv, n)), 1.0)
    r_perp = (F(ratio) * (uv + F(cos_theta) * n)).astype(F)
    r_par = (-F(math.sqrt(abs(1.0 - float(np.dot(r_perp, r_perp))))) * n).astype(F)
    return (r_perp + r_par).astype(F)


def _hit_sphere(o, d, center, radius, t_min, t_max):
    oc = (o - center).astype(F)
    a = float(np.dot(d, d))
    half_b = float(np.dot(oc, d))
    c = float(np.dot(oc, oc)) - float(radius) * float(radius)
    disc = half_b * half_b - a * c
    if disc < 0:
        return None
    sq = math.sqrt(disc)
    root = (-half_b - sq) / a
    if not (t_min <= root <= t_max):
        root = (-half_b + sq) / a
        if not (t_min <= root <= t_max):
            return None
    return root


def _hit_plane(o, d, pl, t_min, t_max):
    denom = float(np.dot(pl["normal"], d))
    if abs(denom) < 1e-8:
        return None
    root = (float(pl["d"]) - float(np.dot(pl["normal"], o))) / denom
    if not (t_min <= root <= t_max):
        return None
    p = o + F(root) * d
    phv = p - pl["base"]
    alpha = float(np.dot(pl["w"], np.cross(phv, pl["v"])))
    beta = float(np.dot(pl["w"], np.cross(pl["u"], phv)))
    t = pl["ptype"]
    if t == 0:  # QUAD
        if not (0.0 <= alpha <= 1.0 and 0.0 <= beta <= 1.0):
            return None
    elif t == 1:  # ELLIPSE
        if (alpha - 0.5) ** 2 + (beta - 0.5) ** 2 > 0.25:
            return None
    else:  # TRIANGLE
        if alpha < 0 or beta < 0 or alpha + beta > 1:
            return None
    return root, alpha, beta


def _sphere_uv(p):
    theta = math.acos(max(-1.0, min(1.0, float(p[1]))))
    phi = math.atan2(-float(p[2]), float(p[0])) + math.pi
    return phi / (2 * math.pi), theta / math.pi


def _nearest_hit(scene, o, d, t_min=1e-3, t_max=1e30):
    best = None
    best_t = t_max
    for k in range(len(scene["sphere_center"])):
        t = _hit_sphere(o, d, scene["sphere_center"][k], scene["sphere_radius"][k], t_min, t_max)
        if t is not None and t < best_t:
            best_t = t
            best = ("sphere", k, t, None, None)
    for k, pl in enumerate(scene["planes"]):
        r = _hit_plane(o, d, pl, t_min, t_max)
        if r is not None and r[0] < best_t:
            best_t = r[0]
            best = ("plane", k, r[0], r[1], r[2])
    return best


def _tex2d(tex, u, v):
    h, w, _ = tex.shape
    u = u - math.floor(u)
    v = v - math.floor(v)
    px = u * w
    py = (1.0 - v) * h
    x0 = min(int(px), w - 1)
    y0 = min(int(py), h - 1)
    x1 = (x0 + 1) % w
    y1 = (y0 + 1) % h
    dx = px - x0
    dy = py - y0
    c00, c10, c01, c11 = tex[y0, x0], tex[y0, x1], tex[y1, x0], tex[y1, x1]
    top = c00 * (1 - dx) + c10 * dx
    bot = c01 * (1 - dx) + c11 * dx
    return (top * (1 - dy) + bot * dy).astype(F)


def _scatter(scene, rng, o_in, d_in, point, normal, front_face, mat, albedo,
             rng_mode="fixed"):
    """Scatter; returns (origin, dir, attenuation, ok).

    rng_mode "fixed": the 8-draw budget shared with the JAX renderer.
    rng_mode "reference": draw consumption exactly as the reference
    binary (materials.h:70-140) — rejection loops, conditional draws.
    """
    mtype = mat["mtype"]
    if rng_mode == "reference":
        if mtype == 0:  # LAMBERTIAN (materials.h:73-79)
            hemi = rng.in_hemisphere_ref(normal)
            direction = hemi if not np.all(np.abs(hemi) < 1e-8) else normal
            return point, direction, albedo, True
        if mtype == 1:  # METAL (materials.h:81-95)
            if float(rng.random_float()) < 0.8:
                ball = rng.in_unit_sphere_ref()
                refl = _reflect(_unit(d_in), normal) + F(mat["fuzz"]) * ball
                return point, refl, albedo, float(np.dot(refl, normal)) > 0.0
            hemi = rng.in_hemisphere_ref(normal)
            direction = hemi if not np.all(np.abs(hemi) < 1e-8) else normal
            return point, direction, albedo, True
        if mtype == 2:  # DIELECTRIC (materials.h:97-133)
            ir = float(mat["ir"])
            ratio = (1.0 / ir) if front_face else ir
            ud = _unit(d_in)
            cos_theta = min(float(np.dot(-ud, normal)), 1.0)
            sin_theta = math.sqrt(max(0.0, 1.0 - cos_theta * cos_theta))
            cannot = ratio * sin_theta > 1.0
            r0 = ((1 - ratio) / (1 + ratio)) ** 2
            refl_p = r0 + (1 - r0) * (1 - cos_theta) ** 5
            # || short-circuit (materials.h:109): the reflectance draw is
            # consumed only when refraction is possible
            if cannot or refl_p > float(rng.random_float()):
                direction = _reflect(ud, normal)
            else:
                direction = _refract(ud, normal, ratio)
            att = np.ones(3, F)
            if not front_face:
                dist = float(np.linalg.norm(point - o_in))
                att = np.exp(-mat["absorption"].astype(np.float64) * dist).astype(F)
            p = float(att.max())
            if float(rng.random_float()) > p:
                return point, direction, att, False
            att = (att / F(p)).astype(F)
            side = 1.0 if float(np.dot(direction, normal)) > 0.0 else -1.0
            origin = (point + normal * F(1e-4 * side)).astype(F)
            return origin, direction, att, True
        return point, normal, albedo, False  # DIFFUSE_LIGHT

    u_choice = rng.random_float()
    hemi = rng.in_hemisphere(normal)
    ball = rng.in_unit_sphere()
    u_refl = rng.random_float()
    u_rr = rng.random_float()

    if mtype == 0:  # LAMBERTIAN
        direction = hemi if not np.all(np.abs(hemi) < 1e-8) else normal
        return point, direction, albedo, True
    if mtype == 1:  # METAL
        if float(u_choice) < 0.8:
            refl = _reflect(_unit(d_in), normal) + F(mat["fuzz"]) * ball
            return point, refl, albedo, float(np.dot(refl, normal)) > 0.0
        direction = hemi if not np.all(np.abs(hemi) < 1e-8) else normal
        return point, direction, albedo, True
    if mtype == 2:  # DIELECTRIC
        ir = float(mat["ir"])
        ratio = (1.0 / ir) if front_face else ir
        ud = _unit(d_in)
        cos_theta = min(float(np.dot(-ud, normal)), 1.0)
        sin_theta = math.sqrt(max(0.0, 1.0 - cos_theta * cos_theta))
        cannot = ratio * sin_theta > 1.0
        r0 = ((1 - ratio) / (1 + ratio)) ** 2
        refl_p = r0 + (1 - r0) * (1 - cos_theta) ** 5
        if cannot or refl_p > float(u_refl):
            direction = _reflect(ud, normal)
        else:
            direction = _refract(ud, normal, ratio)
        att = np.ones(3, F)
        if not front_face:
            dist = float(np.linalg.norm(point - o_in))
            att = np.exp(-mat["absorption"].astype(np.float64) * dist).astype(F)
        p = float(att.max())
        if float(u_rr) > p:
            return point, direction, att, False
        att = (att / F(p)).astype(F)
        side = 1.0 if float(np.dot(direction, normal)) > 0.0 else -1.0
        origin = (point + normal * F(1e-4 * side)).astype(F)
        return origin, direction, att, True
    return point, normal, albedo, False  # DIFFUSE_LIGHT


def ray_color(scene, rng, origin, direction, background, max_depth, rng_mode="fixed",
              rr_start=None):
    final = np.zeros(3, F)
    beta = np.ones(3, F)
    o, d = origin.astype(F), direction.astype(F)
    for depth in range(max_depth):
        hit = _nearest_hit(scene, o, d)
        if hit is None:
            final += beta * background
            break
        kind, k, t, alpha, beta_uv = hit
        if kind == "sphere":
            center = scene["sphere_center"][k]
            radius = scene["sphere_radius"][k]
            point = (o + F(t) * d).astype(F)
            outward = ((point - center) / F(radius)).astype(F)
            front = float(np.dot(d, outward)) < 0.0
            normal = outward if front else -outward
            u, v = _sphere_uv(outward)
            midx = scene["sphere_mat"][k]
        else:
            pl = scene["planes"][k]
            point = (o + F(t) * d).astype(F)
            front = float(np.dot(d, pl["normal"])) < 0.0
            normal = pl["normal"] if front else -pl["normal"]
            u, v = alpha, beta_uv
            midx = pl["mat"]

        mat = scene["materials"][midx]
        albedo = mat["albedo"].copy()
        if mat["tex_id"] >= 0 and scene.get("textures") is not None:
            albedo = (albedo * _tex2d(scene["textures"][mat["tex_id"]], u, v)).astype(F)
        final += beta * mat["emit"]

        # The vectorized renderer advances every lane's seed by 8 per
        # bounce; the oracle must consume the same draws in the same order.
        new_o, new_d, att, ok = _scatter(scene, rng, o, d, point, normal, front, mat, albedo,
                                         rng_mode=rng_mode)
        if not ok:
            break
        beta = (beta * att).astype(F)
        o, d = new_o.astype(F), new_d.astype(F)
        if rr_start is not None:
            # throughput Russian roulette: one extra draw every bounce,
            # kill with probability 1 - max(beta), rescale survivors by 1/p
            u_rr = rng.random_float()
            if depth >= rr_start:
                p = F(min(max(float(beta.max()), 0.05), 1.0))
                if u_rr >= p:
                    break
                beta = (beta * (F(1.0) / p)).astype(F)
    return final


def render(scene, cam, width, height, spp, max_depth, reference_quirk=True,
           rng_mode="fixed", sample_start=0, stratify=False, rr_start=None):
    """Full-frame scalar render; returns [H, W, 3] raw sample sums of the
    global samples [sample_start, sample_start + spp). `stratify` puts
    sample s in cell (s % k, s // k) of a k x k sub-pixel grid,
    k = sqrt(spp)."""
    k = int(round(spp ** 0.5)) if stratify else 0
    fb = np.zeros((height, width, 3), F)
    origin = cam["origin"].astype(F)
    for j in range(height):
        for i in range(width):
            lin = (i * width + j) if reference_quirk else (j * width + i)
            base = wang_hash(lin & M32)
            acc = np.zeros(3, F)
            for s in range(sample_start, sample_start + spp):
                rng = Rng(wang_hash((base + s) & M32))
                pc = (
                    cam["pixel00_loc"]
                    + F(i) * cam["pixel_delta_u"]
                    + F(j) * cam["pixel_delta_v"]
                ).astype(F)
                ox = rng.random_float()
                oy = rng.random_float()
                if k:
                    ox = (F(s % k) + ox) / F(k) - F(0.5)
                    oy = (F(s // k) + oy) / F(k) - F(0.5)
                else:
                    ox, oy = ox - F(0.5), oy - F(0.5)
                sample = (pc + ox * cam["pixel_delta_u"] + oy * cam["pixel_delta_v"]).astype(F)
                d = (sample - origin).astype(F)
                acc += ray_color(scene, rng, origin, d, cam["background"], max_depth,
                                 rng_mode=rng_mode, rr_start=rr_start)
            fb[j, i] = acc
    return fb
