"""Radiance .hdr (RGBE) reader (the port's own copy of
vpt_tpu/utils/hdr.py, host numpy; source/hdr_loader.h in the original).

Reads the header, new-style RLE scanlines, old-style RLE scanlines
((1, 1, 1, n) repeat markers whose shift grows by 8 bits per
consecutive marker, Radiance ``oldreadcolrs``) and flat scanlines, and
converts RGBE to float RGB.  Every well-formed file reads exactly as the
reference reads it.  ``write_hdr`` writes flat or new-style RLE files
(the reference has none; the port's tests and chip_smoke.py make their
maps with it).  One divergence in reading: a run that would overrun its
scanline raises ValueError.  The reference clamps nothing there: an
old-style repeat longer than the rest of the row is cut by numpy's
slice and its count still moves the column past the row's end, so the
rest of the file is read out of step (ROADMAP, known reference faults).
"""

from __future__ import annotations

import numpy as np


def _overrun(path, y, x, count, width):
    raise ValueError(f"{path}: a run of {count} at column {x} of scanline "
                     f"{y} overruns the row of {width} pixels")


def load_hdr(path: str) -> np.ndarray:
    """(H, W, 3) float32 radiance of a Radiance .hdr file."""
    with open(path, "rb") as f:
        data = f.read()
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = data.index(b"\n") + 1
    while True:
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        if line == b"":
            break
    # resolution line, e.g. "-Y 1024 +X 2048"
    end = data.index(b"\n", pos)
    res = data[pos:end].split()
    pos = end + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise NotImplementedError(f"unsupported orientation {res}")
    height = int(res[1])
    width = int(res[3])

    img = np.zeros((height, width, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        # new-style RLE scanline marker: 0x02 0x02 hi lo
        if (8 <= width < 0x8000 and buf[bp] == 2 and buf[bp + 1] == 2
                and ((int(buf[bp + 2]) << 8) | int(buf[bp + 3])) == width):
            bp += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bp])
                    bp += 1
                    n = count - 128 if count > 128 else count
                    if n == 0 or x + n > width:
                        _overrun(path, y, x, n, width)
                    if count > 128:  # run
                        img[y, x:x + n, c] = buf[bp]
                        bp += 1
                    else:            # literal
                        img[y, x:x + n, c] = buf[bp:bp + n]
                        bp += n
                    x += n
            continue
        # old format: flat RGBE pixels with (1, 1, 1, n) old-style repeat
        # markers (repeat the previous pixel n << shift times; each
        # consecutive marker adds 8 to the shift).  Rows without a marker
        # are copied in one piece.
        cand = buf[bp:bp + width * 4]
        if (cand.size == width * 4
                and not np.any((cand[0::4] == 1) & (cand[1::4] == 1)
                               & (cand[2::4] == 1))):
            img[y] = cand.reshape(width, 4)
            bp += width * 4
            continue
        x = 0
        rshift = 0
        while x < width:
            px = buf[bp:bp + 4]
            bp += 4
            if px[0] == 1 and px[1] == 1 and px[2] == 1:
                if x == 0 and y == 0:
                    raise ValueError("old-style RLE repeat with no previous "
                                     "pixel")
                count = int(px[3]) << rshift
                if x + count > width:
                    _overrun(path, y, x, count, width)
                prev = img[y, x - 1] if x else img[y - 1, -1]
                img[y, x:x + count] = prev
                x += count
                rshift += 8
            else:
                img[y, x] = px
                x += 1
                rshift = 0

    return rgbe_to_float(img)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """RGBE -> float RGB as ldexp(rgb, e - 136), 0 where e = 0
    (hdr_loader.h:193-211)."""
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def float_to_rgbe(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) float -> (H, W, 4) uint8 RGBE (Radiance float2rgbe):
    the largest component's exponent, the mantissas scaled by it."""
    img = np.asarray(img, np.float64)
    v = img.max(axis=-1)
    m, e = np.frexp(v)
    ok = v >= 1e-32
    scale = np.where(ok, m * 256.0 / np.where(ok, v, 1.0), 0.0)
    out = np.zeros(img.shape[:-1] + (4,), np.uint8)
    out[..., :3] = np.floor(img * scale[..., None]).clip(0, 255)
    out[..., 3] = np.where(ok, e + 128, 0)
    return out


def _rle_channel(row: np.ndarray) -> bytes:
    """One channel of a new-style RLE scanline: runs of 4 or more equal
    bytes as (128 + n, value), the rest as literals of at most 128."""
    out, lit, x, n = bytearray(), bytearray(), 0, len(row)
    while x < n:
        run = 1
        while x + run < n and run < 127 and row[x + run] == row[x]:
            run += 1
        if run >= 4:
            while lit:
                out += bytes([min(len(lit), 128)]) + lit[:128]
                lit = lit[128:]
            out += bytes([128 + run, int(row[x])])
            x += run
        else:
            lit.append(int(row[x]))
            x += 1
    while lit:
        out += bytes([min(len(lit), 128)]) + lit[:128]
        lit = lit[128:]
    return bytes(out)


def write_hdr(path: str, img: np.ndarray, rle: bool = True) -> None:
    """Write (H, W, 3) float radiance as a Radiance .hdr file, its
    scanlines new-style RLE (``rle``, for widths 8 to 32767) or flat."""
    rgbe = float_to_rgbe(img)
    height, width = rgbe.shape[:2]
    body = bytearray()
    for y in range(height):
        if rle and 8 <= width < 0x8000:
            body += bytes([2, 2, width >> 8, width & 255])
            for c in range(4):
                body += _rle_channel(rgbe[y, :, c])
        else:
            body += rgbe[y].tobytes()
    head = (f"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y {height} "
            f"+X {width}\n").encode()
    with open(path, "wb") as f:
        f.write(head + bytes(body))
