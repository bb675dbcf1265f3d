"""Image output (port of vpt_tpu/utils/io.py, the reference's fileIO
surface, source/util/fileIO.cpp:53-495): PNG through ``zlib`` and
``struct`` (no PIL: the machine with the card has none), EXR through
utils/exr.py.  ``.jpg``, ``.tga`` and ``.bmp`` raise
NotImplementedError."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from vpt_tpu_torch.utils.exr import write_exr

UNPORTED_FORMATS = (".jpg", ".jpeg", ".tga", ".bmp")


def write_png(path: str, img_u8: np.ndarray):
    """8-bit PNG of an (H, W) grey or (H, W, 3) RGB uint8 image."""
    img = np.ascontiguousarray(img_u8, np.uint8)
    if img.ndim == 2:
        color_type = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        color_type = 2
    else:
        raise ValueError(f"PNG: expected (H, W) or (H, W, 3), got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    # each scanline is prefixed with filter type 0 (none)
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, -1)], axis=1)

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))
    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, 3) uint8 from an 8-bit grey or RGB PNG whose
    scanlines are unfiltered, as write_png makes them."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = 8, [], None
    while pos < len(data):
        n, = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color_type, _, _, interlace = head
    if depth != 8 or color_type not in (0, 2) or interlace:
        raise NotImplementedError(f"{path}: PNG {head} is not read")
    ch = 3 if color_type == 2 else 1
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * ch)
    if rows[:, 0].any():
        raise NotImplementedError(f"{path}: filtered scanlines are not read")
    img = rows[:, 1:].reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def save_image(path: str, display_rgb_u8: np.ndarray,
               accum: np.ndarray | None = None, save_exr: bool = False):
    """The display image to ``path`` (.png or .exr); with ``save_exr``
    the raw radiance ``accum`` also goes to the .exr beside it."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        write_png(path, display_rgb_u8)
    elif ext == ".exr":
        if accum is None:
            raise ValueError("EXR output needs the radiance accumulation")
        _write_exr_rgb(path, accum)
        return
    elif ext in UNPORTED_FORMATS:
        raise NotImplementedError(f"{ext} output is not ported (PNG and "
                                  "EXR are)")
    else:
        raise ValueError(f"unsupported image format {ext}")
    if save_exr and accum is not None:
        _write_exr_rgb(os.path.splitext(path)[0] + ".exr", accum)


def _write_exr_rgb(path: str, rgb: np.ndarray):
    write_exr(path, {"R": rgb[..., 0].astype(np.float32),
                     "G": rgb[..., 1].astype(np.float32),
                     "B": rgb[..., 2].astype(np.float32)})


def save_aov(base_path: str, name: str, aov: np.ndarray):
    """A scalar AOV as a raw EXR (channel Y) and a min-max normalised
    grey PNG beside ``base_path`` (main.cpp:1797-1812)."""
    stem = os.path.splitext(base_path)[0]
    write_exr(f"{stem}_{name}.exr", {"Y": aov.astype(np.float32)})
    lo, hi = float(aov.min()), float(aov.max())
    norm = (aov - lo) / (hi - lo) if hi > lo else aov * 0
    write_png(f"{stem}_{name}.png", (norm * 255).astype(np.uint8))
