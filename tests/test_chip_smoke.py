"""Host-side logic of chip_smoke.py (its GPU phases run only on the card)."""

import json
import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from tracer.utils import compile_cache, profiling  # noqa: E402


def test_refuses_a_cpu_platform(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr()
    assert '"ok"' not in out.out
    assert "no GPU" in out.err


def test_fails_without_the_rest_of_the_repo(tmp_path):
    """Alone in a directory, the script exits nonzero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_result_line_has_exactly_the_contract_keys():
    dev = types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    rec = json.loads(chip_smoke.result_line([dev] * 4))
    assert rec == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}


@pytest.mark.parametrize("four", [False, True])
def test_four_selects_only_its_phase(four):
    names = chip_smoke.phase_names(chip_smoke.parse_args(["--four"] if four else []).four)
    assert names[0] == "device"
    if four:
        assert names == ["device", "four"]
    else:
        assert "four" not in names and len(names) == 5
    assert set(names[1:]) <= set(chip_smoke.PHASES)


@pytest.mark.parametrize("line,name,watts", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3", 700.0),
    ("NVIDIA H100 80GB HBM3, 350.00 W\n", "NVIDIA H100 80GB HBM3", 350.0),
    ("NVIDIA H100 PCIe, 310 W", "NVIDIA H100 PCIe", 310.0),
])
def test_parse_nvidia_smi_line(line, name, watts):
    assert profiling.parse_smi(line) == (name, watts)


def test_parse_nvidia_smi_rejects_garbage():
    with pytest.raises(ValueError):
        profiling.parse_smi("[N/A]")


@pytest.mark.parametrize("env_set", [False, True])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.cache_dir() == str(tmp_path)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_frames_agree_counts_pixels_and_mean():
    g = np.random.default_rng(0)
    want = g.uniform(0.1, 1.0, (40, 50, 3))
    assert chip_smoke.frames_agree(want, want) == (1.0, 0.0)
    got = want.copy()
    got[0, 0] = 0.0  # one flipped pixel of 2000
    share, mean_err = chip_smoke.frames_agree(got, want)
    assert share == pytest.approx(1 - 1 / 2000)
    assert 0 < mean_err < chip_smoke.MEAN_RTOL
    with pytest.raises(AssertionError):
        chip_smoke.check_frames("scaled", want * 1.01, want)


def test_config_text_applies_the_cuts(tmp_path):
    from tracer.scene import builders, config

    run = chip_smoke.Run(str(tmp_path), seed=3)
    text = run.config_text(2, body_colours=[(0.6, 0.2, 0.1)] * 3)
    p = config.read_scene_params(text)
    assert (p.width, p.height, p.render.max_depth) == (1080, 720, 50)
    assert p.render.sqrt_rays_per_pixel == 2
    assert p.floor.texture_path == run.texture_path
    assert p.output_path.startswith(str(tmp_path))
    assert [b.col for b in p.bodies] == [(0.6, 0.2, 0.1)] * 3
    scene = builders.create_scene(p)
    assert scene.textures.shape == (1, 1330, 2000, 3)
