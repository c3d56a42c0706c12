"""Texture loading with stb_image `stbi_loadf` semantics.

The reference loads the floor texture with `stbi_loadf` (main.cu:18, 54),
which promotes LDR images to float via (value/max)^2.2 (stb's default
ldr->hdr gamma). We reproduce that so texel values match. PPM (P6/P3) is
decoded with numpy; PNG/JPEG decoding is delegated to PIL, which is then
required (SURVEY.md §2: no need to rewrite a JPEG decoder). A missing or
undecodable file returns None — callers degrade to an untextured
material exactly like the reference (main.cu:19-22).
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np

from tracer.io import image as image_io

STBI_LDR_TO_HDR_GAMMA = 2.2


def load_texture(path: str) -> Optional[np.ndarray]:
    """Load an image file to float32 [H, W, 3] in linear light, or None.

    Raises ImportError when the file needs PIL and PIL is not installed."""
    try:
        with open(path, "rb") as f:
            magic = f.read(2)
        if magic in (b"P6", b"P3"):
            px, maxval = image_io.read_ppm(path)
            rgb = px.astype(np.float32) / float(maxval)
        else:
            rgb = image_io.read_image(path).astype(np.float32) / 255.0
    except (OSError, ValueError) as e:
        print(f"Failed to load texture: {path} ({e})", file=sys.stderr)
        return None
    return np.power(rgb, STBI_LDR_TO_HDR_GAMMA).astype(np.float32)
