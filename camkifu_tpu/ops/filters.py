"""Separable filters: Gaussian blur, Sobel gradients.

Replaces ``cv2.GaussianBlur`` and the gradient stage of ``cv2.Canny``
(SURVEY §2.3). Implemented as separable shift-accumulate stencils, which XLA
fuses into a few elementwise kernels on the GPU.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax


def gaussian_kernel1d(sigma: float, radius: int | None = None) -> np.ndarray:
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _conv1d(img: jnp.ndarray, kernel: np.ndarray, axis: int) -> jnp.ndarray:
    """Convolve a 2D image along one axis with edge padding.

    Shift-accumulate, not conv_general_dilated: a 1-channel conv gives a
    matrix unit almost nothing to do, while k static slices + multiply-adds
    are plain elementwise work, fuse, and stay exact f32 (no reduced-
    precision conv trap)."""
    k = np.asarray(kernel, np.float32)
    r = (len(k) - 1) // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (r, r)
    padded = jnp.pad(img.astype(jnp.float32), pad, mode="edge")
    n = img.shape[axis]
    out = None
    for i, t in enumerate(k):
        sl = lax.slice_in_dim(padded, i, i + n, axis=axis)
        out = float(t) * sl if out is None else out + float(t) * sl
    return out


def gaussian_blur(img: jnp.ndarray, sigma: float = 1.4) -> jnp.ndarray:
    """Separable Gaussian blur of a 2D image."""
    k = gaussian_kernel1d(sigma)
    return _conv1d(_conv1d(img, k, 0), k, 1)


# Sobel kernels (cv2 convention).
_SOBEL_SMOOTH = np.array([1.0, 2.0, 1.0], np.float32)
_SOBEL_DIFF = np.array([-1.0, 0.0, 1.0], np.float32)


def sobel(img: jnp.ndarray):
    """Sobel gradients of a 2D image → (gx, gy)."""
    gx = _conv1d(_conv1d(img, _SOBEL_SMOOTH, 0), _SOBEL_DIFF, 1)
    gy = _conv1d(_conv1d(img, _SOBEL_DIFF, 0), _SOBEL_SMOOTH, 1)
    return gx, gy
