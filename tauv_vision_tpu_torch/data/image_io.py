"""Host image IO (counterpart of ``tauv_vision_tpu/data/image_io.py``).

PNG through PIL, which the card's machine has (as it has cv2 and no
libpng headers for the JAX package's native codec): one codec, no switch
by what happens to import.  PNG is lossless, so an 8-bit file reads back
the bytes that either package wrote.  Only the 8-bit layouts that the
pose and segmentation readers use are decoded: grayscale ("L"), palette
("P", whose indices are the values of a segmentation map), RGB and RGBA;
any other layout (16-bit, 1-bit, float) raises.  So does an image with
alpha (RGBA, or a palette with transparency) read as RGB: the JAX
package's libpng codec composites it over black and its PIL fallback
drops the alpha, so there is no one answer to match.
"""

from __future__ import annotations

import pathlib
from typing import Optional, Union

import numpy as np
from PIL import Image

LAYOUTS = ("L", "P", "RGB", "RGBA")


def read_image(path: Union[str, pathlib.Path], channels: Optional[int] = 3) -> np.ndarray:
    """Read an 8-bit image file to uint8.

    channels=3 -> [H, W, 3] RGB; channels=4 -> [H, W, 4] RGBA.
    channels=1 -> the file's RAW single-channel values [H, W] (the
    segmentation-map contract: grayscale bytes or palette INDICES, never
    a colorimetric conversion; color files come back [H, W, C] for the
    caller to slice).  channels=None -> the file's own layout."""
    if channels not in (None, 1, 3, 4):
        raise ValueError(f"channels must be None, 1, 3 or 4, got {channels}")
    with Image.open(path) as img:
        if img.mode not in LAYOUTS:
            raise ValueError(f"{path}: image mode {img.mode!r} is not one of {LAYOUTS}")
        if channels == 3:
            if img.mode == "RGBA" or "transparency" in img.info:
                raise ValueError(f"{path}: an image with alpha is not read as RGB")
            img = img.convert("RGB")
        elif channels == 4:
            img = img.convert("RGBA")
        out = np.asarray(img)
    if out.dtype != np.uint8:
        raise ValueError(f"{path}: decoded {out.dtype}, not uint8")
    return out


def write_png(path: Union[str, pathlib.Path], img: np.ndarray) -> None:
    """Write an 8-bit [H, W] / [H, W, 3] / [H, W, 4] array as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                          and img.shape[2] not in (3, 4)):
        raise ValueError(f"write_png takes uint8 [H, W(, 3 or 4)], got {img.dtype} "
                         f"{img.shape}")
    Image.fromarray(img).save(path, format="PNG")
