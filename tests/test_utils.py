"""Tests for aux subsystems: debug guards, profiling helpers, multihost split."""

import numpy as np
import jax.numpy as jnp
import pytest

from tracer.utils import debug, profiling
from tracer.dist import multihost


class TestDebug:
    def test_check_finite_passes(self):
        debug.check_finite({"a": jnp.ones((3,)), "b": jnp.zeros((2, 2))})

    def test_check_finite_raises(self):
        with pytest.raises(FloatingPointError, match="non-finite"):
            debug.check_finite({"a": jnp.array([1.0, np.nan])}, name="grads")

    def test_check_framebuffer(self):
        debug.check_framebuffer(np.ones((2, 2, 3)))
        with pytest.raises(FloatingPointError):
            debug.check_framebuffer(np.array([[[1.0, -0.5, 0.0]]]))

    def test_debug_nans_scoped(self):
        import jax

        before = jax.config.jax_debug_nans
        with debug.debug_nans(True):
            assert jax.config.jax_debug_nans
        assert jax.config.jax_debug_nans == before


class TestProfiling:
    def test_time_fn(self):
        t, out = profiling.time_fn(lambda x: x * 2.0, jnp.ones((8, 8)), iters=2)
        assert t >= 0.0 and float(out[0, 0]) == 2.0

    def test_mrays(self):
        assert profiling.mrays_per_s(1000, 1000, 10, 2.0) == 5.0


class TestMultihost:
    def test_my_frames_round_robin(self):
        f0 = multihost.my_frames(10, process_id=0, num_processes=4)
        f3 = multihost.my_frames(10, process_id=3, num_processes=4)
        assert f0 == [0, 4, 8] and f3 == [3, 7]
        allf = sorted(
            sum((multihost.my_frames(10, process_id=p, num_processes=4) for p in range(4)), [])
        )
        assert allf == list(range(10))

    def test_single_process_defaults(self):
        # in-process: one jax process
        assert multihost.my_frames(3) == [0, 1, 2]

    def test_initialize_single_noop(self):
        multihost.initialize(num_processes=1, process_id=0)


class TestResilience:
    def test_retries_transient_then_succeeds(self):
        from tracer.utils import resilience

        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("UNAVAILABLE: worker process crashed")
            return 42

        out = resilience.retry_transient(flaky, retries=3, backoff_s=0.0)
        assert out == 42 and len(calls) == 3

    def test_non_transient_raises_immediately(self):
        import pytest

        from tracer.utils import resilience

        calls = []

        def broken():
            calls.append(1)
            raise ValueError("shape mismatch [3] vs [4]")

        with pytest.raises(ValueError):
            resilience.retry_transient(broken, retries=5, backoff_s=0.0)
        assert len(calls) == 1

    def test_exhausted_retries_propagate(self):
        import pytest

        from tracer.utils import resilience

        def always_down():
            raise RuntimeError("DEADLINE_EXCEEDED: backend unreachable")

        with pytest.raises(RuntimeError, match="DEADLINE_EXCEEDED"):
            resilience.retry_transient(always_down, retries=2, backoff_s=0.0)

    def test_driver_retries_transient_frame(self, tmp_path, monkeypatch):
        import io as _io

        import numpy as np

        from tracer.render import driver, renderer
        from tracer.scene import builders, config

        params = config.read_scene_params(_io.StringIO(config.smoke_config_text()))
        params.width, params.height = 16, 8
        params.num_frames = 1
        params.render.sqrt_rays_per_pixel = 1
        params.render.max_depth = 2
        params.output_path = str(tmp_path / "r_%d.bin")
        scene = builders.create_scene(params, texture_loader=lambda _: None)

        real = renderer.render_frame
        state = {"n": 0}

        def flaky(*a, **kw):
            state["n"] += 1
            if state["n"] == 1:
                raise RuntimeError("UNAVAILABLE: worker process crashed")
            return real(*a, **kw)

        monkeypatch.setattr(renderer, "render_frame", flaky)
        err = _io.StringIO()
        monkeypatch.setattr("sys.stderr", err)
        fb = driver.render_animation(scene, params, out=_io.StringIO(), retries=2)
        assert state["n"] == 2
        assert "transient backend failure" in err.getvalue()
        assert np.isfinite(np.asarray(fb)).all()
