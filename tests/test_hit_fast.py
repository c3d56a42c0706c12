"""The matmul-formulated fast intersector must agree with the reference port."""

import io

import numpy as np
import jax.numpy as jnp
import pytest

import render_modes

from tracer.render import hit as hm
from tracer.render import hit_fast
from tracer.scene import builders, config


def _scene():
    params = config.read_scene_params(io.StringIO(config.smoke_config_text()))
    return builders.create_scene(params, texture_loader=lambda _: None)


def test_fast_matches_brute():
    scene = _scene()
    g = np.random.default_rng(1)
    o = jnp.asarray(g.normal(size=(512, 3), scale=10).astype(np.float32))
    d = jnp.asarray(g.normal(size=(512, 3)).astype(np.float32))

    rb = hm.hit_scene_brute(scene, o, d)
    rf = hit_fast.hit_scene_fast(scene, o, d)

    hb, hf = np.asarray(rb.hit), np.asarray(rf.hit)
    # f32 op-reordering can flip razor-edge hits; demand >=99.5% agreement
    assert (hb == hf).mean() > 0.995
    both = hb & hf
    np.testing.assert_allclose(np.asarray(rf.t)[both], np.asarray(rb.t)[both], rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(rf.normal)[both], np.asarray(rb.normal)[both], rtol=1e-3, atol=2e-4
    )
    np.testing.assert_allclose(
        np.asarray(rf.u)[both], np.asarray(rb.u)[both], rtol=1e-3, atol=2e-3
    )

    # material join must agree exactly where the same primitive won
    mats = scene.materials
    midx = np.asarray(rb.material_idx)
    same_t = both & np.isclose(np.asarray(rf.t), np.asarray(rb.t), rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(rf.mtype)[same_t], np.asarray(mats.mtype)[midx][same_t])
    np.testing.assert_allclose(np.asarray(rf.albedo)[same_t], np.asarray(mats.albedo)[midx][same_t], atol=1e-5)
    np.testing.assert_allclose(np.asarray(rf.emit)[same_t], np.asarray(mats.emit)[midx][same_t], atol=1e-5)
    np.testing.assert_array_equal(np.asarray(rf.tex_id)[same_t], np.asarray(mats.tex_id)[midx][same_t])


def test_fast_render_matches_brute_render():
    from tracer.render import camera as C, renderer

    scene = _scene()
    cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 24, 16, 90.0)
    fb_b = np.asarray(
        renderer.render_frame(scene, cam, 24, 16, spp=2, max_depth=4, intersector="brute", chunk=384)
    )
    fb_f = np.asarray(
        renderer.render_frame(scene, cam, 24, 16, spp=2, max_depth=4, intersector="fast", chunk=384)
    )
    diff = np.abs(fb_f - fb_b).max(axis=-1)
    assert (diff < 1e-3).mean() > 0.99, f"max diff {diff.max()}"


def test_early_exit_matches_scan():
    from tracer.render import camera as C, renderer

    scene = _scene()
    cam = C.build_camera_data([-15.0, 0.0, 4.5], [0.0, 4.5, 0.0], 16, 12, 90.0)
    a = np.asarray(renderer.render_frame(scene, cam, 16, 12, spp=2, max_depth=6, chunk=192))
    b = np.asarray(
        renderer.render_frame(scene, cam, 16, 12, spp=2, max_depth=6, chunk=192, early_exit=True)
    )
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mode", sorted(render_modes.MODES))
def test_fast_matches_brute_in_every_mode(mode):
    """`fast` against the `brute` reference port, frame for frame, in every
    render mode (see render_modes.MODES)."""
    render_modes.assert_frames_agree(
        render_modes.render(mode, "fast"), render_modes.render(mode, "brute"),
        share=0.995, mean_rtol=1e-3)
