"""The zlib + NumPy grayscale PNG codec (data/png.py) that the host decode
path uses in place of an image library."""

import struct
import zlib

import numpy as np
import pytest

from navtech_radar_slam_tpu.config import RadarConfig
from navtech_radar_slam_tpu.data.make_sequence import encode_polar_png
from navtech_radar_slam_tpu.data.mulran import decode_polar_scan
from navtech_radar_slam_tpu.data.png import (
    decode_gray_png, encode_gray_png, read_gray_png, write_gray_png,
)


def _filtered_png(img, ftype):
    """PNG bytes with every row encoded with PNG filter ``ftype`` (0-4, or
    one type per row), written out with the spec's scalar formulas."""
    h, w = img.shape
    a = img.astype(np.int64)
    ftypes = np.broadcast_to(ftype, (h,))
    raw = bytearray()
    for y in range(h):
        ftype = int(ftypes[y])
        raw.append(ftype)
        for x in range(w):
            left = a[y, x - 1] if x else 0
            up = a[y - 1, x] if y else 0
            up_left = a[y - 1, x - 1] if x and y else 0
            if ftype == 0:
                pred = 0
            elif ftype == 1:
                pred = left
            elif ftype == 2:
                pred = up
            elif ftype == 3:
                pred = (left + up) // 2
            else:
                p = left + up - up_left
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
                pred = (left if pa <= pb and pa <= pc
                        else up if pb <= pc else up_left)
            raw.append((a[y, x] - pred) & 0xFF)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


def test_round_trip(tmp_path, rng):
    img = (rng.random((37, 211)) ** 3 * 255).astype(np.uint8)
    img[5] = 255
    img[:, 7] = 0
    path = str(tmp_path / "x.png")
    write_gray_png(path, img)
    np.testing.assert_array_equal(read_gray_png(path), img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
def test_decodes_every_row_filter(rng, ftype):
    img = (rng.random((9, 23)) * 255).astype(np.uint8)
    np.testing.assert_array_equal(decode_gray_png(_filtered_png(img, ftype)),
                                  img)


def test_decodes_mixed_row_filters(rng):
    """Rows of all five types in one image, including runs of Average and
    Paeth rows under rows of the other types."""
    img = (rng.random((31, 57)) ** 2 * 255).astype(np.uint8)
    ftypes = rng.integers(0, 5, img.shape[0])
    ftypes[:5] = [4, 4, 3, 0, 1]
    np.testing.assert_array_equal(decode_gray_png(_filtered_png(img, ftypes)),
                                  img)


def test_written_scan_decodes_like_cv2(tmp_path, rng):
    """A MulRan-format scan written by the codec decodes through
    decode_polar_scan exactly as the same file read by OpenCV does, and an
    OpenCV-written file decodes through the codec unchanged."""
    cv2 = pytest.importorskip("cv2")
    rc = RadarConfig()
    power = rng.random((rc.num_azimuths, rc.padded_range_bins))
    img = encode_polar_png(power, 1_600_000_000_000_000, rc, 0.25)
    ours = str(tmp_path / "1600000000000000.png")
    write_gray_png(ours, img)
    by_cv2 = cv2.imread(ours, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(by_cv2, img)
    a = decode_polar_scan(read_gray_png(ours), rc, 1.6e9, raw_u8=True)
    b = decode_polar_scan(by_cv2, rc, 1.6e9, raw_u8=True)
    for field in ("power", "ray_timestamps", "azimuths", "valid"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))

    theirs = str(tmp_path / "cv2.png")
    cv2.imwrite(theirs, img)
    np.testing.assert_array_equal(read_gray_png(theirs), img)


def test_rejects_unsupported_and_corrupt():
    rgb = bytearray(encode_gray_png(np.zeros((2, 2), np.uint8)))
    rgb[8 + 8 + 9] = 2                       # IHDR colour type -> RGB
    with pytest.raises(ValueError, match="unsupported"):
        decode_gray_png(bytes(rgb))
    bad_filter = bytearray(_filtered_png(np.zeros((2, 3), np.uint8), 0))
    idat = bad_filter.index(b"IDAT") + 4
    body = zlib.compress(b"\x00\x00\x00\x00\x05\x00\x00\x00")
    bad_filter[idat - 8:] = (struct.pack(">I", len(body)) + b"IDAT" + body
                             + struct.pack(">I", zlib.crc32(b"IDAT" + body))
                             + bytes(bad_filter[-12:]))
    with pytest.raises(ValueError, match="unknown PNG filter type 5"):
        decode_gray_png(bytes(bad_filter))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_gray_png(b"garbage bytes, not an image")
    with pytest.raises(ValueError):
        decode_gray_png(b"\x89PNG\r\n\x1a\n" + b"\x00" * 64)
