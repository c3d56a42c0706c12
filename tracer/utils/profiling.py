"""Profiling and timing utilities.

The reference's observability is a per-frame cudaEvent TSV
(src/camera.cu:333-346). The equivalents here: a `jax.profiler` trace
context for op-level analysis, and a frame timer that waits for the
device with `block_until_ready`.
"""

from __future__ import annotations

import contextlib
import re
import subprocess
import time


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Capture a jax.profiler trace (view with TensorBoard/xprof)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_fn(fn, *args, iters: int = 3, **kwargs):
    """Median wall time of fn(*args) with completion forced. Returns
    (seconds, last_result)."""
    import jax

    jax.block_until_ready(fn(*args, **kwargs))  # compile + warm
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


def mrays_per_s(width: int, height: int, spp: int, seconds: float) -> float:
    """reference camera.cu:344-345 convention: W*H*spp rays per frame."""
    return width * height * spp / seconds / 1e6


def nvidia_smi_line() -> str:
    """`name, power.limit` of the first GPU, as nvidia-smi prints them
    (e.g. 'NVIDIA H100 80GB HBM3, 700.00 W'). A card set below its
    maximum power limit runs slower under load, so every number taken on
    a card is reported beside this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def parse_smi(line: str):
    """'NVIDIA H100 80GB HBM3, 700.00 W' -> ('NVIDIA H100 80GB HBM3', 700.0)."""
    name, _, limit = line.strip().rpartition(",")
    m = re.fullmatch(r"\s*([0-9.]+)\s*W\s*", limit)
    if not name or not m:
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), float(m.group(1))
