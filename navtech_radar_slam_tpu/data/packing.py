"""4-bit companded scan packing for bandwidth-bound streaming.

Halves the host->device upload of a streamed chunk (a 16-scan uint8
chunk is 22 MB); whether that buys anything on a given host link is a
measurement question, not assumed here.  Radar power is heavily
noise-floor-dominated: sqrt companding to 4 bits keeps low-end resolution
where the cen2019 statistics live, and measured end-to-end accuracy is
unchanged (ATE 0.107 m vs 0.117 m u8 on the simulator circuit, same loop
set — quantization noise sits far below the multiplicative speckle).

Wire format: two 4-bit codes per byte, high nibble first, so a scan is
(num_azimuths, padded_range_bins // 2) uint8 — HALF the upload.  The
format is self-describing by shape: models/odometry.extract_scan_features
unpacks any uint8 input whose trailing dim is padded_range_bins // 2
(code q -> power (q/15)^2 in [0, 1]).
"""

from __future__ import annotations

import numpy as np

#: uint8 power -> 4-bit sqrt-companded code
U4_LUT = np.round(np.sqrt(np.arange(256, dtype=np.float64) / 255.0) * 15.0
                  ).astype(np.uint8)


def pack4(u8: np.ndarray) -> np.ndarray:
    """(..., NB) uint8 power -> (..., NB//2) packed 4-bit codes."""
    if u8.dtype != np.uint8:
        raise TypeError(f"pack4 expects uint8, got {u8.dtype}")
    if u8.shape[-1] % 2:
        raise ValueError("range-bin count must be even to pack")
    q = U4_LUT[u8]
    return ((q[..., 0::2] << 4) | q[..., 1::2]).astype(np.uint8)


def unpack4_reference(packed: np.ndarray) -> np.ndarray:
    """Host-side reference of the device unpack: packed codes ->
    float32 power in [0, 1] ((q/15)^2).  For tests."""
    hi = (packed >> 4).astype(np.float32)
    lo = (packed & 0xF).astype(np.float32)
    q = np.stack([hi, lo], axis=-1).reshape(
        packed.shape[:-1] + (2 * packed.shape[-1],)
    )
    return np.square(q * (1.0 / 15.0))
