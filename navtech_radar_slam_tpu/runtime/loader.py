"""ctypes bindings for the native radar loader (runtime/src/radar_loader.cc).

The native library decodes MulRan polar PNGs and prefetches them on worker
threads into pre-allocated buffers padded to `RadarConfig.padded_range_bins`,
so the Python consumer only does `device_put` — the host-side analogue of
the reference's C++ file-reading front-end loop (README.md:27).

The library is not shipped prebuilt: the first use builds it into
`runtime/lib/` with `make` (g++ + libpng).  Without that toolchain it falls
back cleanly — callers check `native_available()` and use the NumPy
decoder (data/mulran.py), and the CLI reports which loader ran.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from navtech_radar_slam_tpu.config import RadarConfig

_RUNTIME_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB_PATH = os.path.join(_RUNTIME_DIR, "lib", "libradar_loader.so")

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def _load_library():
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-C", _RUNTIME_DIR],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except subprocess.CalledProcessError as e:
                err = e.stderr.decode(errors="replace").strip().splitlines()
                # the compiler's first error names the cause (a missing
                # header, say); make's own last line does not
                why = next((ln for ln in err if "error" in ln),
                           err[-1] if err else str(e))
                _build_error = f"make failed: {why.strip()}"
                return None
            except (OSError, subprocess.TimeoutExpired) as e:
                _build_error = f"make did not run: {e}"
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError as e:
            _build_error = f"cannot load {_LIB_PATH}: {e}"
            return None

        lib.radar_loader_create.restype = ctypes.c_void_p
        lib.radar_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.radar_loader_next.restype = ctypes.c_int
        lib.radar_loader_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.radar_loader_destroy.restype = None
        lib.radar_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.radar_decode_png.restype = ctypes.c_int
        lib.radar_decode_png.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ]
        # raw-uint8 variants (normalize-on-device path); absent in a stale
        # prebuilt library -> loader falls back to float mode
        try:
            lib.radar_loader_create_u8.restype = ctypes.c_void_p
            lib.radar_loader_create_u8.argtypes = (
                lib.radar_loader_create.argtypes
            )
            lib.radar_loader_next_u8.restype = ctypes.c_int
            lib.radar_loader_next_u8.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.radar_decode_png_u8.restype = ctypes.c_int
            lib.radar_decode_png_u8.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ]
            lib._has_u8 = True
        except AttributeError:
            lib._has_u8 = False
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_library() is not None


def native_build_error() -> Optional[str]:
    """Why the native library is unavailable (None if it loaded or has not
    been tried yet)."""
    return _build_error


def _alloc(cfg: RadarConfig, raw_u8: bool = False):
    na, pb = cfg.num_azimuths, cfg.padded_range_bins
    return (
        np.zeros((na, pb), np.uint8 if raw_u8 else np.float32),
        np.zeros((na,), np.float64),
        np.zeros((na,), np.float32),
        np.zeros((na,), np.uint8),
    )


def decode_png_native(
    path: str, cfg: RadarConfig
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """One-shot native decode: (power, timestamps, azimuths, valid)."""
    lib = _load_library()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    power, ts, az, valid = _alloc(cfg)
    rc = lib.radar_decode_png(
        path.encode(), cfg.num_azimuths, cfg.num_range_bins,
        cfg.padded_range_bins, cfg.meta_columns,
        power.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        az.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    if rc != 0:
        raise IOError(f"native decode failed ({rc}): {path}")
    return power, ts, az, valid


class NativeRadarLoader:
    """Sequential prefetching iterator over a list of scan PNGs.

    ``raw_u8=True`` yields power as the raw PNG bytes (uint8, padded) for
    the normalize-on-device path: the jitted front-end casts /255 on chip,
    so host->device traffic drops 4x vs float32.  Every jitted consumer
    (extract_scan_features and everything above it) accepts either dtype."""

    def __init__(self, paths: List[str], cfg: Optional[RadarConfig] = None,
                 num_workers: int = 2, queue_capacity: int = 8,
                 raw_u8: bool = False):
        self.cfg = cfg or RadarConfig()
        lib = _load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self.raw_u8 = bool(raw_u8) and getattr(lib, "_has_u8", False)
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        create = lib.radar_loader_create_u8 if self.raw_u8 else \
            lib.radar_loader_create
        self._handle = create(
            arr, len(self._paths), self.cfg.num_azimuths,
            self.cfg.num_range_bins, self.cfg.padded_range_bins,
            self.cfg.meta_columns, num_workers, queue_capacity,
        )
        if not self._handle:
            raise RuntimeError("failed to create native loader")
        self._n = len(paths)
        self._consumed = 0

    def __len__(self) -> int:
        return self._n

    def __iter__(self):
        return self

    def __next__(self):
        if self._consumed >= self._n or self._handle is None:
            raise StopIteration
        power, ts, az, valid = _alloc(self.cfg, self.raw_u8)
        idx = ctypes.c_int64(-1)
        if self.raw_u8:
            rc = self._lib.radar_loader_next_u8(
                self._handle,
                power.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                az.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(idx),
            )
        else:
            rc = self._lib.radar_loader_next(
                self._handle,
                power.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                az.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                ctypes.byref(idx),
            )
        if rc != 0:
            raise StopIteration
        self._consumed += 1
        return power, ts, az, valid.astype(bool)

    def close(self):
        if self._handle is not None:
            self._lib.radar_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
