"""Device compute primitives replacing the reference's OpenCV calls (SURVEY §2.3).

Every ``cv2.*`` primitive the reference leans on has a JAX/XLA
equivalent here; unit tests score each against the OpenCV-on-host oracle.
All functions are pure, static-shape, jit/vmap/scan-friendly.
"""

from camkifu_tpu.ops.color import rgb_to_gray, to_float
from camkifu_tpu.ops.warp import (
    homography_dlt,
    canonical_corners,
    warp_to_canonical,
    warp_batch_fixed,
    warp_batch_chunked,
    apply_homography,
)
from camkifu_tpu.ops.zones import extract_zones, zone_features, zone_stats
from camkifu_tpu.ops.kmeans import kmeans, luminance_ordered_labels
from camkifu_tpu.ops.edges import edge_map
from camkifu_tpu.ops.hough import hough_lines

__all__ = [
    "rgb_to_gray", "to_float",
    "homography_dlt", "canonical_corners", "warp_to_canonical",
    "warp_batch_fixed", "warp_batch_chunked", "apply_homography",
    "extract_zones", "zone_features", "zone_stats",
    "kmeans", "luminance_ordered_labels",
    "edge_map", "hough_lines",
]
