"""Color conversions (replaces ``cv2.cvtColor`` uses — SURVEY §2.3).

Frames arrive as uint8 RGB (the host feeder converts BGR→RGB once at decode);
on-device math runs in float32 (small images; bf16 reserved for the big matmul
paths where it pays).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

# ITU-R BT.601 luma weights — identical to cv2.cvtColor(..., COLOR_RGB2GRAY).
# (numpy, not jnp: module-level jnp constants become tracers if the module is
# first imported inside a jit trace.)
_LUMA = np.array([0.299, 0.587, 0.114], dtype=np.float32)


def to_float(frame: jnp.ndarray) -> jnp.ndarray:
    """uint8 [0,255] → float32 [0,1]. No-op for float inputs."""
    if frame.dtype == jnp.uint8:
        return frame.astype(jnp.float32) / 255.0
    return frame.astype(jnp.float32)


def rgb_to_gray(frame: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) RGB → (...,) luma, same scale as input."""
    return jnp.tensordot(frame.astype(jnp.float32), _LUMA, axes=([-1], [0]),
                         precision="highest")


def rgb_to_gray_u8(frame: jnp.ndarray) -> jnp.ndarray:
    """(..., 3) RGB (uint8 or float in [0,1]) → (...,) uint8 luma.

    For gather-heavy consumers (the rectification warps): uint8 taps read 4×
    fewer device-memory bytes than float32 and the 1/255 quantization is far below the
    signal the consumers extract (edge profiles are percentile-normalized).
    """
    g = rgb_to_gray(frame)
    if frame.dtype != jnp.uint8:
        g = g * 255.0
    return jnp.clip(g + 0.5, 0.0, 255.0).astype(jnp.uint8)
