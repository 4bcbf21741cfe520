import os

import numpy as np
import pytest

from navtech_radar_slam_tpu.config import RadarConfig
from navtech_radar_slam_tpu.data.mulran import decode_polar_scan
from navtech_radar_slam_tpu.data.png import read_gray_png, write_gray_png
from navtech_radar_slam_tpu.runtime import (
    NativeRadarLoader,
    decode_png_native,
    native_available,
)


@pytest.fixture(autouse=True)
def _needs_native_loader():
    # decided per test, not at import: the first call builds the library
    if not native_available():
        pytest.skip("native loader could not be built (g++/libpng missing)")


CFG = RadarConfig()


def write_mulran_png(path, rng, stamp_us=1_600_000_000_000_000):
    """Synthesize a polar scan PNG in oxford/MulRan format (11 meta cols)."""
    na, nb = CFG.num_azimuths, CFG.num_range_bins
    img = np.zeros((na, CFG.meta_columns + nb), np.uint8)
    power = (rng.random((na, nb)) * 255).astype(np.uint8)
    img[:, CFG.meta_columns:] = power
    for a in range(na):
        ts = np.int64(stamp_us + a * 100).astype("<i8")
        img[a, :8] = np.frombuffer(ts.tobytes(), np.uint8)
        enc = np.uint16(int(a / na * 5600)).astype("<u2")
        img[a, 8:10] = np.frombuffer(enc.tobytes(), np.uint8)
        img[a, 10] = 255
    write_gray_png(path, img)
    return power


def test_native_decode_matches_python(tmp_path, rng):
    p = str(tmp_path / "1600000000000000.png")
    raw_power = write_mulran_png(p, rng)

    power, ts, az, valid = decode_png_native(p, CFG)
    assert power.shape == (CFG.num_azimuths, CFG.padded_range_bins)
    np.testing.assert_allclose(
        power[:, : CFG.num_range_bins], raw_power / 255.0, atol=1e-6
    )
    assert abs(ts[0] - 1_600_000_000_000_000 * 1e-6) < 1e-3
    assert abs(ts[10] - ts[0] - 10 * 100e-6) < 1e-6
    assert valid.all()

    img = read_gray_png(p)
    ref = decode_polar_scan(img, CFG, 0.0)
    np.testing.assert_allclose(power, ref.power, atol=1e-6)
    np.testing.assert_allclose(az, ref.azimuths, atol=1e-6)
    np.testing.assert_allclose(ts, ref.ray_timestamps, rtol=1e-12)


def test_prefetcher_order_and_content(tmp_path, rng):
    paths = []
    powers = []
    for i in range(6):
        p = str(tmp_path / f"{1600000000000000 + i}.png")
        powers.append(write_mulran_png(p, rng, stamp_us=1_600_000_000_000_000 + i))
        paths.append(p)

    loader = NativeRadarLoader(paths, CFG, num_workers=2, queue_capacity=3)
    assert len(loader) == 6
    count = 0
    for (power, ts, az, valid), expect in zip(loader, powers):
        np.testing.assert_allclose(
            power[:, : CFG.num_range_bins], expect / 255.0, atol=1e-6
        )
        count += 1
    assert count == 6
    loader.close()


def test_native_decode_missing_file():
    with pytest.raises(IOError):
        decode_png_native("/nonexistent/scan.png", CFG)


def test_native_decode_corrupt_file(tmp_path):
    """A truncated/corrupt PNG must raise, not crash or return garbage."""
    p = tmp_path / "9999999999999999.png"
    p.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)   # header, no chunks
    with pytest.raises(IOError):
        decode_png_native(str(p), CFG)

    q = tmp_path / "not_a_png.png"
    q.write_bytes(b"garbage bytes, not an image")
    with pytest.raises(IOError):
        decode_png_native(str(q), CFG)


def test_raw_u8_loader_parity(tmp_path, rng):
    """raw_u8 mode (normalize-on-device ingestion): native u8 loader, native
    float loader, and the NumPy u8 decoder must agree bit-exactly."""
    p = str(tmp_path / "1600000000000000.png")
    raw_power = write_mulran_png(p, rng)

    ld = NativeRadarLoader([p], CFG, raw_u8=True)
    pu, ts, az, valid = next(ld)
    assert pu.dtype == np.uint8
    np.testing.assert_array_equal(pu[:, : CFG.num_range_bins], raw_power)

    pf, tsf, azf, _ = decode_png_native(p, CFG)
    np.testing.assert_allclose(pu.astype(np.float32) / 255.0, pf, atol=1e-7)
    np.testing.assert_allclose(ts, tsf)
    np.testing.assert_allclose(az, azf)

    img = read_gray_png(p)
    ref = decode_polar_scan(img, CFG, 0.0, raw_u8=True)
    assert ref.power.dtype == np.uint8
    np.testing.assert_array_equal(pu, ref.power)


def test_uint8_feature_extraction_parity(tmp_path, rng):
    """The jitted front-end must produce identical features for raw uint8
    scans (cast /255 on device) and pre-normalized float32 scans."""
    import jax.numpy as jnp

    from navtech_radar_slam_tpu.config import SlamConfig
    from navtech_radar_slam_tpu.models.odometry import extract_scan_features

    p = str(tmp_path / "1600000000000000.png")
    write_mulran_png(p, rng)
    pu, _, az, _ = next(NativeRadarLoader([p], CFG, raw_u8=True))
    pf, _, _, _ = decode_png_native(p, CFG)

    cfg = SlamConfig()
    f_u8 = extract_scan_features(jnp.asarray(pu), jnp.asarray(az), cfg)
    f_f32 = extract_scan_features(jnp.asarray(pf), jnp.asarray(az), cfg)
    np.testing.assert_array_equal(np.asarray(f_u8.valid), np.asarray(f_f32.valid))
    np.testing.assert_allclose(
        np.asarray(f_u8.xy), np.asarray(f_f32.xy), atol=1e-6
    )
