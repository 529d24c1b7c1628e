"""Host-side image IO (counterpart of ``sei_tpu/data/loader.py``).

Images are decoded to float32 numpy CHW in [0, 1] with the JAX package's
channel policy: alpha dropped, grey replicated to 3 channels.  Writing is
torchvision's ``save_image`` rule: ``x * 255 + 0.5``, clamped, truncated to
8 bits.

PNG files go through the port's own small codec, numpy and the standard
library's ``zlib``, with no imaging library: 8-bit grey, grey + alpha, RGB
and RGBA, not interlaced, any of the five row filters on reading; filter 0
(none) on writing.  It decodes to the same bytes as Pillow.  Other formats
(``.jpg``, ``.jpeg``) import Pillow where they are read or written, and
raise if it is absent.  This numpy codec is the plain version of the
native loader (:mod:`.native`), which ``GroundTruthDataset`` uses for PNG
files.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples per pixel
_COLOUR_TYPE = {n: t for t, n in _SAMPLES.items()}


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk up to IEND, CRCs checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter(rows: np.ndarray, h: int, w: int, spp: int) -> np.ndarray:
    """Undo the PNG row filters: rows (h, 1 + w * spp) uint8, each led by
    its filter type -> (h, w, spp) uint8.  Sub, Average and Paeth depend on
    the pixel to the left and Up, Average and Paeth on the row above, so
    the pixels are rebuilt one anti-diagonal (row + column = d) at a time,
    each diagonal in one vectorized step."""
    kinds = rows[:, 0]
    filt = rows[:, 1:].reshape(h, w, spp)
    if not kinds.any():
        return filt
    if kinds.max() > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    f = filt.astype(np.int32)
    out = np.zeros((h + 1, w + 1, spp), np.int32)  # a zero row above, a zero column left
    r_all = np.arange(h)
    for d in range(h + w - 1):
        r = r_all[max(0, d - w + 1):min(h, d + 1)]
        x = d - r
        a, b, c = out[r + 1, x], out[r, x + 1], out[r, x]  # left, up, up-left
        k = kinds[r][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[r + 1, x + 1] = (f[r, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png_rows(path: str) -> tuple[np.ndarray, int, int, int]:
    """An 8-bit PNG's inflated image data, before the row filters are
    undone: (rows (H, 1 + W * samples) uint8, each led by its filter type,
    H, W, samples).  Chunk CRCs, the header and the data size are checked;
    anything else raises."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, compression, filter_method, interlace = header
    if depth != 8 or colour not in _SAMPLES or compression or filter_method or interlace:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}); 8-bit grey, grey+alpha, RGB or RGBA, not "
                         "interlaced, are supported")
    spp = _SAMPLES[colour]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from e
    if raw.size != h * (1 + w * spp):
        raise ValueError(f"{path}: PNG data of {raw.size} bytes for {w}x{h}x{spp}")
    return raw.reshape(h, 1 + w * spp), h, w, spp


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG to (H, W, samples) uint8."""
    return _unfilter(*read_png_rows(path))


def write_png(path: str, arr: np.ndarray) -> None:
    """Encode (H, W) or (H, W, 1|2|3|4) uint8 as an 8-bit PNG, filter 0."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    h, w, spp = arr.shape
    if spp not in _COLOUR_TYPE:
        raise ValueError(f"cannot write {spp} channels as PNG")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * spp)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[spp], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(_SIGNATURE + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def _pil_image(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(f"{path}: {os.path.splitext(path)[1]} files need Pillow, which is "
                           "not installed (PNG files need nothing)") from e
    return Image


def _is_png(path: str) -> bool:
    return path.lower().endswith(".png")


def read_image(path: str, *, channels: int = 3) -> np.ndarray:
    """Decode an image file to float32 CHW in [0, 1]."""
    if _is_png(path):
        arr = read_png(path)
    else:
        with _pil_image(path).open(path) as im:
            arr = np.asarray(im)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    x = arr.astype(np.float32) / 255.0
    x = np.transpose(x, (2, 0, 1))
    if channels == 3:
        if x.shape[0] == 4:
            x = x[:3]
        elif x.shape[0] == 1:
            x = np.repeat(x, 3, axis=0)
        elif x.shape[0] != 3:
            raise ValueError(f"Unexpected number of channels: {x.shape[0]}")
    return x


def write_image(path: str, x: np.ndarray) -> None:
    """Save float CHW [0, 1] as 8 bits (multiply by 255, add 0.5, clamp,
    truncate)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    x = np.asarray(x)
    if x.ndim == 4:
        x = x[0]
    arr = np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)
    arr = np.transpose(arr, (1, 2, 0))
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    if _is_png(path):
        write_png(path, arr)
    else:
        _pil_image(path).fromarray(arr).save(path)
