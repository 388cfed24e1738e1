"""Minimal OpenEXR scanline codec, pure Python and zlib (counterpart of
adamvs_tpu/io/exr.py, which it copies).

WHU_OMVS ground-truth depths ship as single-channel ``.exr`` files (the
reference reads them with ``cv2.imread(..., IMREAD_UNCHANGED)``,
datasets/cas_total_rscv.py:440-446). OpenCV builds often lack EXR support,
so this codec covers the subset of the format the data needs: EXR v2,
scanline storage, INCREASING_Y, NONE / ZIP / ZIPS compression, HALF / FLOAT
/ UINT channels. A file it writes is byte for byte the JAX package's.

Format reference: the public OpenEXR file-layout documentation
(openexr.com/en/latest/OpenEXRFileLayout.html).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = 20000630
_PIXEL_DTYPES = {0: np.dtype("<u4"), 1: np.dtype("<f2"), 2: np.dtype("<f4")}
_PIXEL_CODES = {np.dtype("<u4"): 0, np.dtype("<f2"): 1, np.dtype("<f4"): 2}
# compression id -> scanlines per chunk
_LINES_PER_BLOCK = {0: 1, 1: 1, 2: 1, 3: 16}  # NONE, RLE(unsupported), ZIPS, ZIP


def _read_cstring(buf: bytes, pos: int) -> tuple[str, int]:
    end = buf.index(b"\x00", pos)
    return buf[pos:end].decode("ascii"), end + 1


def _zip_uncompress(data: bytes, expected: int) -> bytes:
    raw = np.frombuffer(zlib.decompress(data), dtype=np.uint8)
    if raw.size != expected:
        raise ValueError(f"EXR zip chunk: got {raw.size} bytes, expected {expected}")
    # inverse predictor: t[i] = t[i-1] + t[i] - 128 (mod 256)
    t = np.cumsum(raw.astype(np.int64) - np.concatenate(([0], np.full(raw.size - 1, 128, np.int64))))
    t = (t % 256).astype(np.uint8)
    # de-interleave: first half -> even bytes, second half -> odd bytes
    half = (t.size + 1) // 2
    out = np.empty(t.size, dtype=np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _zip_compress(data: bytes) -> bytes:
    raw = np.frombuffer(data, dtype=np.uint8)
    half = (raw.size + 1) // 2
    t = np.concatenate([raw[0::2], raw[1::2]])
    d = np.empty_like(t)
    d[0] = t[0]
    d[1:] = (t[1:].astype(np.int16) - t[:-1].astype(np.int16) + 128).astype(np.uint8)
    return zlib.compress(d.tobytes(), 6)


def read_exr(path: str) -> dict[str, np.ndarray]:
    """Read all channels of a scanline EXR into {name: [H,W] array}."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    if magic != _MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR not supported")
    pos = 8

    channels: list[tuple[str, np.dtype]] = []
    compression = 0
    data_window = (0, 0, 0, 0)
    while True:
        name, pos = _read_cstring(buf, pos)
        if not name:
            break
        _type, pos = _read_cstring(buf, pos)
        (size,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos : pos + size]
        pos += size
        if name == "channels":
            cpos = 0
            while payload[cpos] != 0:
                cname, cpos = _read_cstring(payload, cpos)
                (ptype,) = struct.unpack_from("<i", payload, cpos)
                cpos += 16  # type(4) + pLinear/reserved(4) + xSampling(4) + ySampling(4)
                channels.append((cname, _PIXEL_DTYPES[ptype]))
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<4i", payload)

    if compression not in _LINES_PER_BLOCK:
        raise ValueError(f"{path}: unsupported EXR compression id {compression}")
    xmin, ymin, xmax, ymax = data_window
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    lines_per_block = _LINES_PER_BLOCK[compression]
    num_chunks = -(-height // lines_per_block)

    # line offset table (we read chunks sequentially; offsets validated implicitly)
    pos += 8 * num_chunks

    bytes_per_line = sum(dt.itemsize for _, dt in channels) * width
    out = {cname: np.empty((height, width), dtype=dt) for cname, dt in channels}

    for _ in range(num_chunks):
        y, size = struct.unpack_from("<ii", buf, pos)
        pos += 8
        chunk = buf[pos : pos + size]
        pos += size
        y0 = y - ymin
        nlines = min(lines_per_block, height - y0)
        expected = bytes_per_line * nlines
        if compression in (2, 3):  # ZIPS / ZIP
            if size < expected:
                chunk = _zip_uncompress(chunk, expected)
        elif compression != 0:
            raise ValueError(f"unsupported compression {compression}")
        # chunk layout: per scanline, per channel (sorted by name), a full row
        off = 0
        for line in range(nlines):
            for cname, dt in channels:
                row = np.frombuffer(chunk, dtype=dt, count=width, offset=off)
                out[cname][y0 + line] = row
                off += width * dt.itemsize
    return out


def read_exr_depth(path: str) -> np.ndarray:
    """Read a depth EXR as float32 [H,W] (first channel, preferring Z/Y/R)."""
    chans = read_exr(path)
    for key in ("Z", "Y", "R"):
        if key in chans:
            return np.asarray(chans[key], dtype=np.float32)
    first = sorted(chans.keys())[0]
    return np.asarray(chans[first], dtype=np.float32)


def write_exr(path: str, channels: dict[str, np.ndarray], compression: str = "zip") -> None:
    """Write a scanline EXR. ``channels`` maps name -> [H,W] array
    (float32 / float16 / uint32)."""
    comp_id = {"none": 0, "zips": 2, "zip": 3}[compression]
    names = sorted(channels.keys())
    arrays = [np.ascontiguousarray(channels[n]) for n in names]
    h, w = arrays[0].shape
    dtypes = [np.dtype(a.dtype).newbyteorder("<") for a in arrays]

    header = b""

    def attr(name: str, typ: str, payload: bytes) -> bytes:
        return (
            name.encode("ascii") + b"\x00" + typ.encode("ascii") + b"\x00"
            + struct.pack("<i", len(payload)) + payload
        )

    chlist = b""
    for n, dt in zip(names, dtypes):
        chlist += n.encode("ascii") + b"\x00"
        chlist += struct.pack("<i", _PIXEL_CODES[dt]) + b"\x00\x00\x00\x00"
        chlist += struct.pack("<ii", 1, 1)
    chlist += b"\x00"
    box = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header += attr("channels", "chlist", chlist)
    header += attr("compression", "compression", bytes([comp_id]))
    header += attr("dataWindow", "box2i", box)
    header += attr("displayWindow", "box2i", box)
    header += attr("lineOrder", "lineOrder", b"\x00")
    header += attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\x00"

    lines_per_block = _LINES_PER_BLOCK[comp_id]
    num_chunks = -(-h // lines_per_block)

    chunks = []
    for c in range(num_chunks):
        y0 = c * lines_per_block
        nlines = min(lines_per_block, h - y0)
        parts = []
        for line in range(nlines):
            for a, dt in zip(arrays, dtypes):
                parts.append(a[y0 + line].astype(dt, copy=False).tobytes())
        raw = b"".join(parts)
        if comp_id in (2, 3):
            packed = _zip_compress(raw)
            if len(packed) >= len(raw):  # EXR stores raw if compression doesn't help
                packed = raw
        else:
            packed = raw
        chunks.append((y0, packed))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        offset = 8 + len(header) + 8 * num_chunks
        for y0, packed in chunks:
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(packed)
        for y0, packed in chunks:
            f.write(struct.pack("<ii", y0, len(packed)))
            f.write(packed)


def write_exr_depth(path: str, depth: np.ndarray, compression: str = "zip") -> None:
    write_exr(path, {"Z": np.asarray(depth, dtype=np.float32)}, compression=compression)
