"""Host-side image I/O.

Host copy of ``stereo_reconstruction_tpu/io/image.py``. Images are read as
uint8 RGB (the reference's ``cv::imread``, ``data_loader.cpp:71-72``, keeps
BGR; the reference math is channel-symmetric), PNGs through the native
decoder (``io/native.py``) first and PIL second, as the JAX package does.
PIL is imported only when it is needed, so a machine without it reads
PNGs through the native decoder alone. The reference's uint8 PNG
round-trip of disparity (``main.cpp:42,50``) is kept as an explicit
compatibility function.
"""

from __future__ import annotations

import numpy as np


def read_image(path: str, grayscale: bool = False) -> np.ndarray:
    """Read an image as uint8, shape (H, W, 3) RGB or (H, W) grayscale.

    A PNG goes through the native decoder where it is built; other files,
    and PNGs it cannot decode (16-bit, interlaced), go through PIL. Where
    neither can read the file, the error names both."""
    native_error = "not tried (not a .png)"
    if path.lower().endswith(".png"):
        from stereo_reconstruction_tpu_torch.io import native

        if native.available():
            try:
                return native.read_png(path, channels=1 if grayscale else 3)
            except (IOError, OSError) as exc:
                native_error = str(exc)
        else:
            native_error = f"not available ({native.build_error()})"
    try:
        from PIL import Image
    except ImportError as exc:
        raise RuntimeError(f"cannot read {path}: the native decoder failed "
                           f"({native_error}) and PIL is not installed ({exc})") from exc
    with Image.open(path) as im:
        return np.asarray(im.convert("L" if grayscale else "RGB"), dtype=np.uint8)


def write_image(path: str, array: np.ndarray) -> None:
    """Write a uint8 array ((H, W) or (H, W, 3)) as PNG with PIL. Float
    inputs are rounded and clipped to [0, 255] first."""
    from PIL import Image

    arr = np.asarray(array)
    if arr.dtype != np.uint8:
        arr = np.clip(np.round(arr), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def disparity_png_roundtrip(disparity: np.ndarray) -> np.ndarray:
    """Quantize disparity to uint8 and back to float32.

    Mirrors the reference pipeline's write-then-read of the disparity map
    (``main.cpp:42,50``): values are rounded, clipped to [0, 255], and
    returned as float.
    """
    q = np.clip(np.round(disparity), 0, 255).astype(np.uint8)
    return q.astype(np.float32)
