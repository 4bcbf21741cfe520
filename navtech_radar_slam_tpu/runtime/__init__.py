from navtech_radar_slam_tpu.runtime.loader import (  # noqa: F401
    NativeRadarLoader,
    decode_png_native,
    native_available,
    native_build_error,
)
