"""Minimal self-contained OpenEXR codec (uncompressed scanlines).

A copy of ``cpu_ray_tracing_implementation_tpu/utils/exr.py`` (numpy only;
the port imports nothing of the JAX package). The reference vendors
tinyexr to read ``bathroom.exr`` (src/image.h:33-67) and writes only 8-bit
PPM. No EXR backend is assumed on the host (imageio may lack one), so the
dependency-free subset is implemented here from the OpenEXR 2.0 file
layout:

- write: single-part scanline file, compression NONE, FLOAT or HALF
  channels (B, G, R in the required alphabetical chlist order)
- read: single-part scanline files with compression NONE, HALF/FLOAT/UINT
  channels, arbitrary data windows

That covers full-fidelity HDR output of linear radiance (film.write_exr)
and round-tripping the port's own files through utils/image_io.load_image.
Compressed files from other tools raise a clear error naming the
limitation rather than decoding garbage.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 20000630
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_NP_OF_PT = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}


# --------------------------------------------------------------- writing
def _attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img, half: bool = False) -> None:
    """Write linear [H,W,3] float data as a scanline EXR (no compression).

    ``half``: store 16-bit floats (half the size, ~3 decimal digits);
    default is full float32.
    """
    a = np.asarray(img, np.float32)
    if a.ndim != 3 or a.shape[-1] < 3:
        raise ValueError(f"expected [H,W,3] image, got {a.shape}")
    a = a[..., :3]
    h, w = a.shape[:2]
    dt = np.float16 if half else np.float32
    pt = _PT_HALF if half else _PT_FLOAT
    a = a.astype(dt)

    # chlist entries must be alphabetical: B, G, R
    ch = b""
    for name in (b"B", b"G", b"R"):
        ch += name + b"\0" + struct.pack("<iBBBBii", pt, 0, 0, 0, 0, 1, 1)
    ch += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = (
        _attr(b"channels", b"chlist", ch)
        + _attr(b"compression", b"compression", b"\0")  # 0 = NONE
        + _attr(b"dataWindow", b"box2i", box)
        + _attr(b"displayWindow", b"box2i", box)
        + _attr(b"lineOrder", b"lineOrder", b"\0")  # increasing Y
        + _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
        + _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0))
        + _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
        + b"\0"
    )

    pre = struct.pack("<ii", _MAGIC, 2) + header
    table_at = len(pre)
    data_at = table_at + 8 * h
    bpp = a.dtype.itemsize
    line_bytes = 3 * w * bpp
    chunk_bytes = 8 + line_bytes  # y + size prefix per scanline chunk

    with open(path, "wb") as f:
        f.write(pre)
        offs = data_at + np.arange(h, dtype=np.uint64) * chunk_bytes
        f.write(offs.astype("<u8").tobytes())
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            # per scanline: all of B, then G, then R (chlist order)
            f.write(a[y, :, 2].tobytes())
            f.write(a[y, :, 1].tobytes())
            f.write(a[y, :, 0].tobytes())


# --------------------------------------------------------------- reading
def _read_cstr(buf: bytes, at: int) -> tuple[bytes, int]:
    end = buf.index(b"\0", at)
    return buf[at:end], end + 1


def read_exr(path: str) -> np.ndarray:
    """Read a single-part uncompressed scanline EXR to float32 [H,W,3].

    Channels R/G/B are mapped to the output; a luminance-only file (Y)
    broadcasts to all three. Raises ValueError for compressed, tiled, or
    multi-part files (out of scope for this minimal codec).
    """
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR unsupported by minimal codec")
    if version & 0x800:
        raise ValueError(f"{path}: deep-data EXR unsupported")
    if version & 0x1000:
        raise ValueError(f"{path}: multi-part EXR unsupported")

    at = 8
    channels: list[tuple[str, int]] = []
    compression = None
    dw = None
    while True:
        if buf[at] == 0:  # end of header
            at += 1
            break
        name, at = _read_cstr(buf, at)
        _typ, at = _read_cstr(buf, at)
        (size,) = struct.unpack_from("<i", buf, at)
        at += 4
        payload = buf[at:at + size]
        at += size
        if name == b"channels":
            p = 0
            while payload[p] != 0:
                cname, p = _read_cstr(payload, p)
                ptype, xs, ys = struct.unpack_from("<i4xii", payload, p)
                p += 16  # type + pLinear/reserved + x/ySampling
                if xs != 1 or ys != 1:
                    raise ValueError(
                        f"{path}: subsampled channel {cname!r} "
                        f"(sampling {xs}x{ys}) unsupported")
                channels.append((cname.decode(), ptype))
        elif name == b"compression":
            compression = payload[0]
        elif name == b"dataWindow":
            dw = struct.unpack("<iiii", payload)

    if compression != 0:
        raise ValueError(
            f"{path}: compression {compression} unsupported (minimal codec "
            "reads uncompressed scanlines only)")
    if dw is None or not channels:
        raise ValueError(f"{path}: missing dataWindow/channels")
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1

    (n_chunks,) = (h,)
    offsets = np.frombuffer(buf, "<u8", count=n_chunks, offset=at)

    planes = {name: np.zeros((h, w), np.float32) for name, _ in channels}
    for off in offsets:
        o = int(off)
        y, size = struct.unpack_from("<ii", buf, o)
        o += 8
        row = y - y0
        for cname, ptype in channels:  # chlist order within the scanline
            npt = _NP_OF_PT[ptype]
            n = w * np.dtype(npt).itemsize
            vals = np.frombuffer(buf, npt, count=w, offset=o)
            planes[cname][row] = vals.astype(np.float32)
            o += n

    if all(c in planes for c in "RGB"):
        return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)
    if "Y" in planes:
        return np.repeat(planes["Y"][..., None], 3, axis=-1)
    first = planes[channels[0][0]]
    return np.repeat(first[..., None], 3, axis=-1)
