"""8-bit grayscale PNG codec in zlib + NumPy.

MulRan / Oxford polar radar scans are 8-bit grayscale PNGs (colour type 0,
bit depth 8, no interlace), so the host decode path needs nothing beyond
the standard library and NumPy.  The reader undoes all five PNG row
filters: None, Sub and Up row by row, and any image with Average or Paeth
rows (which libpng's adaptive filtering writes) along anti-diagonals; the
writer emits filter type 1 (Sub) on every row.  Other PNG
flavours (palette, colour, 16-bit, interlaced) are rejected with
ValueError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def encode_gray_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8 array -> PNG file bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"need a 2-D uint8 image, got {img.dtype} {img.shape}")
    h, w = img.shape
    # Sub filter: each byte minus its left neighbour (mod 256)
    sub = np.empty_like(img)
    sub[:, 0] = img[:, 0]
    sub[:, 1:] = img[:, 1:] - img[:, :-1]
    raw = np.empty((h, w + 1), np.uint8)
    raw[:, 0] = 1
    raw[:, 1:] = sub
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_gray_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_gray_png(img))


def _unfilter_wavefront(rows: np.ndarray) -> np.ndarray:
    """Undo any mix of the five row filters, vectorised over rows.

    Pixel (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1), so all
    pixels on one anti-diagonal x + y = d are independent of each other.
    The image is stored skewed, one anti-diagonal per row, so each of the
    h + w - 1 steps is a few NumPy operations over the h image rows.  Cells
    left of x = 0 stay 0, the spec's value for a missing left or upper-left
    neighbour."""
    h, w = rows.shape[0], rows.shape[1] - 1
    ftype = rows[:, 0]
    yy, xx = np.indices((h, w))
    diag = xx + yy + 1
    skew_raw = np.zeros((h + w, h), np.int16)    # [anti-diagonal, image row]
    skew_raw[diag, yy] = rows[:, 1:]
    out = np.zeros((h + w, h + 1), np.int16)     # column 0: the zero prior row
    zero = np.zeros(h, np.int16)
    has_avg, has_paeth = bool((ftype == 3).any()), bool((ftype == 4).any())
    avg = paeth = zero
    for d in range(1, h + w):
        a = out[d - 1, 1:]                       # left
        b = out[d - 1, :-1]                      # up
        c = out[d - 2, :-1] if d > 1 else zero   # up-left
        if has_avg:
            avg = (a + b) >> 1
        if has_paeth:
            # with p = a + b - c: p - a = b - c, p - b = a - c
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
        cur = out[d, 1:]
        np.add(skew_raw[d], np.choose(ftype, (zero, a, b, avg, paeth)),
               out=cur)
        np.bitwise_and(cur, 0xFF, out=cur)
    return out[diag, yy + 1].astype(np.uint8)


def decode_gray_png(data: bytes) -> np.ndarray:
    """PNG file bytes -> (H, W) uint8 array."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if (depth, colour, interlace) != (8, 0, 0):
        raise ValueError(
            f"unsupported PNG: bit depth {depth}, colour type {colour}, "
            f"interlace {interlace} (need 8-bit grayscale, not interlaced)")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"corrupt PNG data: {e}") from e
    if len(raw) != h * (w + 1):
        raise ValueError("PNG data size does not match its header")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w + 1)
    if rows[:, 0].max() > 4:
        raise ValueError(f"unknown PNG filter type {rows[:, 0].max()}")
    if rows[:, 0].max() > 2:
        # Average or Paeth rows depend on their left neighbour through a
        # non-linear predictor: no per-row prefix sum exists
        return _unfilter_wavefront(rows)
    img = np.empty((h, w), np.uint8)
    prior = np.zeros(w, np.uint8)
    for y in range(h):
        ftype, cur = rows[y, 0], rows[y, 1:].copy()
        if ftype == 1:
            cur = np.cumsum(cur, dtype=np.uint8)
        elif ftype == 2:
            cur += prior
        img[y] = cur
        prior = cur
    return img


def read_gray_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_gray_png(f.read())
