"""Minimal OpenEXR scanline reader/writer (copy of vpt_tpu/utils/exr.py,
which the port may not import), without an OpenEXR dependency:

* read: single-part scanline images, NONE/ZIPS/ZIP compression,
  HALF/FLOAT/UINT channels;
* write: FLOAT scanlines, NONE/ZIPS/ZIP (render output).

PIZ is not copied: nothing the port writes or reads uses it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

MAGIC = 20000630
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
_PT_DTYPE = {PT_HALF: np.float16, PT_FLOAT: np.float32, PT_UINT: np.uint32}
_LINES_PER_BLOCK = {0: 1, 2: 1, 3: 16}  # NONE, ZIPS, ZIP


def _read_cstr(data, pos):
    end = data.index(b"\x00", pos)
    return data[pos:end].decode("latin-1"), end + 1


def _zip_decode(raw: bytes) -> bytes:
    """ImfZip::uncompress: t[0] = d[0], t[i] = t[i-1] + d[i] - 128, then
    undo the even/odd interleave split."""
    arr = np.frombuffer(zlib.decompress(raw), np.uint8)
    arr = ((np.cumsum(arr.astype(np.int64) - 128) + 128) % 256).astype(
        np.uint8)
    half = (len(arr) + 1) // 2
    inter = np.zeros(len(arr), np.uint8)
    inter[0::2] = arr[:half]
    inter[1::2] = arr[half:]
    return inter.tobytes()


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Returns {channel_name: (H, W) float32 array}."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<iI", data, 0)
    if magic != MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise NotImplementedError("tiled EXR unsupported")
    if version & 0x1000:
        raise NotImplementedError("multi-part EXR unsupported")
    if version & 0x800:
        raise NotImplementedError("deep EXR unsupported")

    pos = 8
    attrs = {}
    while True:
        name, pos = _read_cstr(data, pos)
        if name == "":
            break
        typ, pos = _read_cstr(data, pos)
        size = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        attrs[name] = (typ, data[pos:pos + size])
        pos += size

    chl = attrs["channels"][1]
    channels = []
    cpos = 0
    while chl[cpos] != 0:
        cname, cpos = _read_cstr(chl, cpos)
        ptype = struct.unpack_from("<i", chl, cpos)[0]
        cpos += 16
        channels.append((cname, ptype))
    # channels are stored alphabetically; scanline data follows that order
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    W = xmax - xmin + 1
    H = ymax - ymin + 1
    compression = attrs["compression"][1][0]
    if compression not in _LINES_PER_BLOCK:
        raise NotImplementedError(f"EXR compression {compression}")
    lines_per_block = _LINES_PER_BLOCK[compression]

    n_blocks = -(-H // lines_per_block)
    offsets = struct.unpack_from(f"<{n_blocks}q", data, pos)

    out = {c: np.zeros((H, W), np.float32) for c, _ in channels}
    for off in offsets:
        y, nbytes = struct.unpack_from("<iI", data, off)
        raw = data[off + 8: off + 8 + nbytes]
        nlines = min(lines_per_block, ymax - y + 1)
        expect = sum(W * np.dtype(_PT_DTYPE[pt]).itemsize
                     for _, pt in channels) * nlines
        if compression and len(raw) < expect:  # stored raw if zip lost
            raw = _zip_decode(raw)
        rpos = 0
        for line in range(nlines):
            yy = y - ymin + line
            for cname, ptype in channels:
                dt = np.dtype(_PT_DTYPE[ptype])
                n = W * dt.itemsize
                vals = np.frombuffer(raw[rpos:rpos + n], dt)
                out[cname][yy] = vals.astype(np.float32)
                rpos += n
    return out


def read_exr_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 from R/G/B channels."""
    ch = read_exr(path)
    for want in (("R", "G", "B"), ("r", "g", "b")):
        if all(c in ch for c in want):
            return np.stack([ch[want[0]], ch[want[1]], ch[want[2]]], -1)
    raise ValueError(f"{path}: no RGB channels in {list(ch)}")


def _zip_encode(raw: bytes) -> bytes:
    """ImfZip::compress: interleave split, then delta predictor."""
    arr = np.frombuffer(raw, np.uint8)
    split = np.concatenate([arr[0::2], arr[1::2]]).astype(np.int64)
    delta = np.empty_like(split)
    delta[0] = split[0]
    delta[1:] = split[1:] - split[:-1] + 128
    return zlib.compress((delta % 256).astype(np.uint8).tobytes())


def write_exr(path: str, channels: dict[str, np.ndarray],
              compression: str = "none"):
    """FLOAT scanline EXR writer (compression: "none" | "zip" | "zips")."""
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_block = _LINES_PER_BLOCK[comp_id]
    names = sorted(channels)
    H, W = channels[names[0]].shape
    for c in names:
        if channels[c].shape != (H, W):
            raise ValueError(f"channel {c}: shape {channels[c].shape}, "
                             f"expected {(H, W)}")

    def attr(name, typ, payload):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<I", len(payload)) + payload)

    chlist = b""
    for c in names:
        chlist += c.encode() + b"\x00" + struct.pack("<iiii", PT_FLOAT, 0, 1,
                                                     1)
    chlist += b"\x00"

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = b"".join([
        attr("channels", "chlist", chlist),
        attr("compression", "compression", bytes([comp_id])),
        attr("dataWindow", "box2i", box),
        attr("displayWindow", "box2i", box),
        attr("lineOrder", "lineOrder", b"\x00"),
        attr("pixelAspectRatio", "float", struct.pack("<f", 1.0)),
        attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0)),
        attr("screenWindowWidth", "float", struct.pack("<f", 1.0)),
        b"\x00",
    ])
    head = struct.pack("<iI", MAGIC, 2) + header
    # (H, C, W) float32 planes: one scanline is its channels in order
    planes = np.stack([np.asarray(channels[c], np.float32) for c in names],
                      axis=1)
    blocks = []
    for y0 in range(0, H, lines_per_block):
        raw = np.ascontiguousarray(planes[y0:y0 + lines_per_block]).tobytes()
        enc = _zip_encode(raw) if comp_id else raw
        if len(enc) >= len(raw):  # EXR stores raw if zip doesn't win
            enc = raw
        blocks.append((y0, enc))
    pos = len(head) + 8 * len(blocks)
    offsets = []
    for _y0, enc in blocks:
        offsets.append(pos)
        pos += 8 + len(enc)
    body = b"".join(struct.pack("<q", o) for o in offsets)
    body += b"".join(struct.pack("<iI", y0, len(enc)) + enc
                     for y0, enc in blocks)
    with open(path, "wb") as f:
        f.write(head + body)
