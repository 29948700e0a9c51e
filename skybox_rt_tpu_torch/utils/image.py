"""PNG I/O + image comparison against the reference goldens.

Counterpart of skybox_rt_tpu.utils.image.  The reference saves its ARGB8888
framebuffer bottom-up (negative pitch, draw3d/main.cpp:385-386) and compares
with cocogfx CompareImages at a per-channel tolerance (main.cpp:505-514).
Framebuffer layout here: (H, W) uint32 with a<<24 | r<<16 | g<<8 | b, row 0
at the bottom of the displayed image (GL window convention).

PNGs are written, and the files written here read back, with the standard
library's zlib, so a machine without PIL renders to files too;
:func:`load_png_argb` reads any PNG and needs PIL.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_RGBA8 = (8, 6, 0, 0, 0)   # bit depth, color type RGBA, deflate, filters, no interlace


def framebuffer_to_rgba(fb: np.ndarray) -> np.ndarray:
    """(H, W) uint32 ARGB -> (H, W, 4) uint8 RGBA, flipped to image order."""
    fb = np.asarray(fb, np.uint32)
    a = (fb >> 24).astype(np.uint8)
    r = ((fb >> 16) & 0xFF).astype(np.uint8)
    g = ((fb >> 8) & 0xFF).astype(np.uint8)
    b = (fb & 0xFF).astype(np.uint8)
    rgba = np.stack([r, g, b, a], axis=-1)
    return rgba[::-1]  # bottom-up save


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png_rgba(path: str, rgba: np.ndarray) -> None:
    """(H, W, 4) uint8 RGBA, row 0 at the top -> an 8-bit RGBA PNG (every
    row with filter type 0), written with zlib alone."""
    rgba = np.ascontiguousarray(rgba, np.uint8)
    h, w, c = rgba.shape
    if c != 4:
        raise ValueError(f"expected (H, W, 4) RGBA, got {rgba.shape}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgba.reshape(h, w * 4)], axis=1)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">II5B", w, h, *_RGBA8)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png_rgba(path: str) -> np.ndarray:
    """A PNG as :func:`write_png_rgba` writes it (8-bit RGBA, every row
    with filter type 0) -> (H, W, 4) uint8, row 0 at the top; zlib alone.
    Other PNGs: :func:`load_png_argb`."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">II5B", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, *mode = header
    if tuple(mode) != _RGBA8:
        raise ValueError(f"{path}: not an 8-bit non-interlaced RGBA PNG")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * 4)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0 (None)")
    return raw[:, 1:].reshape(h, w, 4).copy()


def save_framebuffer_png(path: str, fb: np.ndarray) -> None:
    write_png_rgba(path, framebuffer_to_rgba(fb))


def load_png_argb(path: str) -> np.ndarray:
    """Golden PNG -> (H, W) uint32 ARGB in *image* row order (top-down).
    Reads any PNG through PIL."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("load_png_argb reads PNGs through PIL (Pillow), "
                          "which is not installed") from e
    im = Image.open(path).convert("RGBA")
    a = np.asarray(im, np.uint32)
    return (a[..., 3] << 24) | (a[..., 0] << 16) | (a[..., 1] << 8) | a[..., 2]


def compare_to_golden(fb: np.ndarray, golden_path: str, tolerance: int = 1):
    """cocogfx CompareImages semantics: count pixels where any channel
    differs by more than `tolerance`.  Returns (errors, max_channel_diff)."""
    golden = load_png_argb(golden_path)
    got = np.asarray(fb, np.uint32)[::-1]  # flip to image order
    assert got.shape == golden.shape, (got.shape, golden.shape)

    def chans(x):
        return np.stack([(x >> s) & 0xFF for s in (24, 16, 8, 0)], -1).astype(np.int32)

    diff = np.abs(chans(got) - chans(golden))
    per_pixel = diff.max(-1)
    errors = int((per_pixel > tolerance).sum())
    return errors, int(per_pixel.max())
