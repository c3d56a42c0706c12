"""Tests for config parsing and scene construction (counts, materials)."""

import io

import numpy as np

from tracer.scene import builders, config
from tracer.scene import types as T


class TestConfigParser:
    def test_reference_config_txt(self):
        # the reference's sample config (print_default_config) parses
        p = config.read_scene_params(io.StringIO(config.default_config_text()))
        assert p.num_frames == 100
        assert (p.width, p.height) == (1080, 720)
        assert p.fov_degrees == 50.0
        assert p.camera_path.rc0 == 15.0 and p.camera_path.pzc == -1.57
        assert len(p.bodies) == 3
        assert p.bodies[0].center == (0.0, 0.0, 3.0)
        assert p.bodies[0].lights_on_edge == 3
        assert p.bodies[2].radius == 3.0
        assert p.floor.texture_path == "floor.jpg"
        assert p.floor.reflection_coeff == 0.3
        assert len(p.lights) == 4
        assert p.lights[0].col == (10.0, 10.0, 10.0)
        assert p.render.max_depth == 50
        assert p.render.sqrt_rays_per_pixel == 50

    def test_default_config_roundtrip(self):
        p = config.read_scene_params(io.StringIO(config.default_config_text()))
        assert p.num_frames == 100
        assert len(p.bodies) == 3 and len(p.lights) == 4

    def test_smoke_config(self):
        p = config.read_scene_params(io.StringIO(config.smoke_config_text()))
        assert (p.width, p.height) == (200, 100)
        assert p.render.max_depth == 5 and p.render.sqrt_rays_per_pixel == 2

    def test_lights_clamped_to_four(self):
        # main.cu:536-540 clamps num_lights to 4; extra light data then
        # misparses into render params in the reference too, so only test
        # the clamp with exactly 4 + trailing render params.
        text = config.smoke_config_text()
        p = config.read_scene_params(io.StringIO(text))
        assert len(p.lights) <= 4


class TestPolyhedra:
    def _counts(self, builder, lights_on_edge):
        buf = builders.SceneBuffers()
        buf.add_material(T.LAMBERTIAN)
        builder(buf, (0, 0, 0), 3.0, 0, lights_on_edge, 0, 0)
        return len(buf.plane_type), len(buf.sphere_radius)

    def test_cube_counts(self):
        # 6 face quads + 12 border quads; 12 edges x lights (main.cu:62-129)
        planes, spheres = self._counts(builders.add_cube, 2)
        assert planes == 18 and spheres == 24

    def test_octahedron_counts(self):
        # 8 tris + 12 border quads (main.cu:248-308)
        planes, spheres = self._counts(builders.add_octahedron, 3)
        assert planes == 20 and spheres == 36

    def test_dodecahedron_counts(self):
        # 12 faces x 3 tris + 30 unique edges (main.cu:134-233)
        planes, spheres = self._counts(builders.add_dodecahedron, 1)
        assert planes == 66 and spheres == 30

    def test_vertices_on_circumsphere(self):
        buf = builders.SceneBuffers()
        buf.add_material(T.LAMBERTIAN)
        builders.add_dodecahedron(buf, (1.0, 2.0, 3.0), 2.5, 0, 0, 0, 0)
        # every triangle vertex must lie on the radius-2.5 sphere
        center = np.array([1.0, 2.0, 3.0])
        for k in range(len(buf.plane_type)):
            if buf.plane_type[k] == T.TRIANGLE:
                a = buf.plane_base[k]
                b = a + buf.plane_u[k]
                c = a + buf.plane_v[k]
                for v in (a, b, c):
                    np.testing.assert_allclose(np.linalg.norm(v - center), 2.5, rtol=1e-5)


class TestCreateScene:
    def _params(self):
        return config.read_scene_params(io.StringIO(config.smoke_config_text()))

    def test_config_scene_counts(self):
        # SURVEY.md §6: 105 planes, 94 spheres for the canonical 3-body,
        # 4-light scene with lights_on_edge = 3/2/1.
        p = self._params()
        scene = builders.create_scene(p, texture_loader=lambda _: None)
        assert scene.num_planes == 105
        assert scene.num_spheres == 94
        # materials: floor + edge_light + 3x(body+border) + 4 lights = 12
        assert scene.num_materials == 12

    def test_material_derivations(self):
        p = self._params()
        scene = builders.create_scene(p, texture_loader=lambda _: None)
        mats = scene.materials
        m = np.asarray
        # floor: METAL, albedo=tint, fuzz=reflection (main.cu:349-360)
        assert int(m(mats.mtype)[0]) == T.METAL
        np.testing.assert_allclose(m(mats.albedo)[0], [1, 1, 1])
        np.testing.assert_allclose(m(mats.fuzz)[0], 0.3)
        # edge light: emit = lights[0].col * 0.1 (main.cu:363-366)
        assert int(m(mats.mtype)[1]) == T.DIFFUSE_LIGHT
        np.testing.assert_allclose(m(mats.emit)[1], [1.0, 1.0, 1.0])
        # body 0: DIELECTRIC ir = 1+1.5, absorption = 0.45*(1-col) (main.cu:375-383)
        assert int(m(mats.mtype)[2]) == T.DIELECTRIC
        np.testing.assert_allclose(m(mats.ir)[2], 2.5)
        np.testing.assert_allclose(
            m(mats.absorption)[2], 0.45 * (1 - np.array([0.3, 0, 0])), rtol=1e-5
        )
        # border: METAL albedo 0.5, fuzz 0.6 (main.cu:389-392)
        assert int(m(mats.mtype)[3]) == T.METAL
        np.testing.assert_allclose(m(mats.fuzz)[3], 0.6)
        # point light materials emit light color (main.cu:417-423)
        np.testing.assert_allclose(m(mats.emit)[8], [10, 10, 10])
        # light spheres have radius 1.0 (main.cu:425)
        np.testing.assert_allclose(m(scene.spheres.radius)[-4:], 1.0)

    def test_missing_texture_degrades(self):
        p = self._params()
        p.floor.texture_path = "/nonexistent/file.jpg"
        scene = builders.create_scene(p)
        assert scene.textures is None
        assert int(np.asarray(scene.materials.tex_id)[0]) == -1
