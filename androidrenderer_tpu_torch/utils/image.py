"""Image IO + metrics: dependency-free PNG writer and SSIM.

SSIM here implements the standard Wang et al. 2004 formulation (gaussian 11x11,
K1=0.01, K2=0.03) — the fidelity gate from BASELINE.json (SSIM >= 0.98 vs reference
renders).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def save_png(path: str, image: np.ndarray) -> None:
    """Write (H, W, 3|4) u8 or float [0,1] to a PNG file (pure python + zlib)."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None].repeat(3, axis=-1)
    h, w, c = img.shape
    color_type = {3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x**2) / (2 * sigma**2))
    return g / g.sum()


def _filter2d(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' gaussian filter over the leading two axes."""
    from numpy.lib.stride_tricks import sliding_window_view

    n = k.size
    a = sliding_window_view(img, n, axis=0) @ k
    return sliding_window_view(a, n, axis=1) @ k


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    """Mean SSIM between two images (H, W[, C]); channels averaged."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx, my = _filter2d(x, k), _filter2d(y, k)
        mxx = _filter2d(x * x, k) - mx * mx
        myy = _filter2d(y * y, k) - my * my
        mxy = _filter2d(x * y, k) - mx * my
        s = ((2 * mx * my + c1) * (2 * mxy + c2)) / (
            (mx * mx + my * my + c1) * (mxx + myy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))
