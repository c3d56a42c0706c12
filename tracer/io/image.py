"""Framebuffer quantization and image savers.

Functional replacement of the reference `ISaver` strategy hierarchy
(include/camera.cuh:31-84, src/camera.cu:52-153): one vectorized
quantize step (divide by spp, sqrt gamma, clamp to [0, 0.999], scale by
256 — camera.cu:54-73) feeding four writers:

  write_ppm      - FileSaver       (P3 text PPM, camera.cu:56-73)
  write_ppm_text - OutStreamSaver  (P3 PPM to a stream, camera.cu:75-92)
  write_png      - PNGSaver        (camera.cu:94-126, zlib instead of stb)
  write_binary   - BinarySaver     (int32 w, h + raw RGB, camera.cu:128-153)

Both reference frame drivers instantiate BinarySaver (camera.cu:300, 357),
so that is the CLI default.
"""

from __future__ import annotations

import struct
import sys
import zlib

import numpy as np


def quantize(framebuffer: np.ndarray, samples_per_pixel: int) -> np.ndarray:
    """Raw sample sums [H, W, 3] -> uint8 [H, W, 3].

    reference camera.cu:64-73: mean, gamma = sqrt (linearToGamma,
    camera.cu:54), clamp to [0, 0.999], * 256, truncate.
    """
    c = np.asarray(framebuffer, np.float32) / float(samples_per_pixel)
    g = np.sqrt(np.maximum(c, 0.0))
    return (256.0 * np.clip(g, 0.0, 0.999)).astype(np.uint8)


def write_ppm(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """P3 text PPM (FileSaver, camera.cu:56-73)."""
    with open(path, "w") as f:
        _write_ppm_stream(f, framebuffer, samples_per_pixel)


def write_ppm_text(stream, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """P3 PPM to an open text stream (OutStreamSaver, camera.cu:75-92)."""
    _write_ppm_stream(stream or sys.stdout, framebuffer, samples_per_pixel)


def _write_ppm_stream(f, framebuffer, samples_per_pixel):
    h, w, _ = framebuffer.shape
    q = quantize(framebuffer, samples_per_pixel)
    f.write(f"P3\n{w} {h}\n255\n")
    out = "\n".join(" ".join(str(int(v)) for v in px) for px in q.reshape(-1, 3))
    f.write(out + "\n")


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> 8-bit RGB PNG bytes (no filtering, zlib level 6)."""
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    # every scanline starts with filter type 0 (None)
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)],
        axis=1,
    )
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """PNG (PNGSaver, camera.cu:94-126). PNG bytes regardless of the
    path's extension, like stbi_write_png on whatever path it was given."""
    with open(path, "wb") as f:
        f.write(encode_png(quantize(framebuffer, samples_per_pixel)))


def read_ppm(path: str) -> np.ndarray:
    """Read a binary (P6) or text (P3) PPM. Returns (pixels, maxval):
    pixels [H, W, 3] uint8, or uint16 when maxval > 255."""
    with open(path, "rb") as f:
        data = f.read()
    magic = data[:2]
    if magic not in (b"P6", b"P3"):
        raise ValueError(f"{path}: not a PPM (magic {magic!r})")
    tokens, pos = [], 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":  # comment to end of line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PPM header")
        tokens.append(int(data[start:pos]))
    w, h, maxval = tokens
    if not (0 < maxval < 65536) or w <= 0 or h <= 0:
        raise ValueError(f"{path}: bad PPM header {tokens}")
    if magic == b"P3":
        vals = np.array(data[pos:].split(), np.int64)
        px = vals[: w * h * 3]
    else:
        pos += 1  # exactly one whitespace byte before the raster
        dtype = np.dtype(np.uint8) if maxval < 256 else np.dtype(">u2")
        px = np.frombuffer(data, dtype, count=w * h * 3, offset=pos)
    if px.size != w * h * 3:
        raise ValueError(f"{path}: PPM raster has {px.size} of {w * h * 3} values")
    out_dtype = np.uint8 if maxval < 256 else np.uint16
    return px.astype(out_dtype).reshape(h, w, 3), maxval


def write_ppm_binary(path: str, rgb: np.ndarray) -> None:
    """uint8 [H, W, 3] -> binary P6 PPM."""
    h, w, _ = rgb.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(rgb, np.uint8).tobytes())


def read_image(path: str) -> np.ndarray:
    """Decode a PPM (numpy) or, through PIL, a PNG/JPEG to [H, W, 3]
    uint8. PIL is needed only for the latter."""
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic in (b"P6", b"P3"):
        px, maxval = read_ppm(path)
        if maxval != 255:
            px = np.round(px.astype(np.float64) * (255.0 / maxval)).astype(np.uint8)
        return px
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"decoding {path} needs Pillow (PIL), which is not installed; "
            "convert the image to a binary PPM (P6) to load it without PIL"
        ) from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def write_binary(path: str, framebuffer: np.ndarray, samples_per_pixel: int) -> None:
    """int32 width, int32 height, then raw RGB bytes row-major
    (BinarySaver, camera.cu:128-153)."""
    h, w, _ = framebuffer.shape
    q = quantize(framebuffer, samples_per_pixel)
    with open(path, "wb") as f:
        f.write(struct.pack("<ii", w, h))
        f.write(q.tobytes())


def read_binary(path: str) -> np.ndarray:
    """Inverse of write_binary (for tests/tools): uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        w, h = struct.unpack("<ii", f.read(8))
        data = np.frombuffer(f.read(w * h * 3), np.uint8)
    return data.reshape(h, w, 3)


SAVERS = {
    "ppm": write_ppm,
    "png": write_png,
    "bin": write_binary,
}


class ThreadedWriter:
    """Background-thread frame writer with the AsyncFrameWriter interface.

    Fallback/complement to the native C++ writer (tracer.io.native): the
    encode (zlib for PNG releases the GIL) and disk write happen off the
    render loop so the accelerator starts frame n+1 while frame n is
    written — the reference writes synchronously in-loop
    (camera.cu:211-215). Exceptions from the worker are re-raised at
    wait()/close() so a full disk is not silently ignored.
    """

    def __init__(self, max_queued: int = 4):
        import queue
        import threading

        self._q = queue.Queue(maxsize=max_queued)
        self._err = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                path, fb, divisor, fmt = item
                SAVERS[fmt](path, fb, divisor)
            except Exception as e:  # surfaced at wait()/close()
                self._err = e
            finally:
                self._q.task_done()

    def submit(self, path: str, framebuffer: np.ndarray, divisor: int,
               fmt: str = "png") -> None:
        self._q.put((path, framebuffer, divisor, fmt))

    def wait(self) -> None:
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def close(self) -> None:
        # Shut the worker down even when wait() re-raises a write error
        # (otherwise the sentinel is never sent and the daemon thread
        # leaks — advisor round-2 low finding).
        try:
            self.wait()
        finally:
            self._q.put(None)
            self._thread.join()
