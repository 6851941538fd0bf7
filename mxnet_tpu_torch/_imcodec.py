"""The port's image codec: JPEG and PNG without PIL (the card's machine
has no PIL; the JAX package decodes with it).

`csrc/imcodec.cc` holds baseline JPEG decode and encode and PNG's row
filters; g++ builds it at first use into the gitignored `_build/`, under
a name that hashes the source and the flags, as `recordio.py` builds its
reader. Where g++ cannot build it, every call raises `MXNetError` with
g++'s output: there is no other decoder to fall back on. PNG's inflate
and deflate are the standard library's `zlib`.

A decode is one ctypes call, which runs without the GIL. Pixels come
back as numpy arrays in PIL's modes, so that `convert` can give PIL's
conversions bit for bit:

  decode(buf)        -> Decoded(pixels, mode, palette)
                        mode "L" (H, W), "LA" (H, W, 2), "RGB" (H, W, 3),
                        "RGBA" (H, W, 4) or "P" (H, W) palette indices
  convert(d, "L" | "RGB")
  encode_jpeg(img, quality=95, sampling=(2, 2))   baseline, libjpeg's
                        tables and quality scaling, 4:2:0 for colour
  encode_png(img, level=6)                        8-bit, 1-4 channels

The JPEG decoder follows libjpeg's islow IDCT, fancy upsampling and
fixed-point colour conversion (a decode of libjpeg's files agrees with
libjpeg's to the bit or within one level); it refuses progressive,
arithmetic-coded, lossless, 12-bit and CMYK / YCCK files with an
`MXNetError` naming the variant. PNG takes 1-, 2-, 4- and 8-bit grey and
palette images and 8-bit grey+alpha, RGB and RGBA, not interlaced;
16-bit and Adam7 files raise. A sub-byte grey image reads as "L" scaled
to 0-255 (PIL's mode "1" reads as booleans instead).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib
from collections import namedtuple
from pathlib import Path

import numpy as np

from .base import MXNetError

__all__ = ["Decoded", "image_format", "decode", "convert", "encode_jpeg",
           "encode_png"]

_SRC = Path(__file__).resolve().parent / "csrc" / "imcodec.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_UNSUPPORTED = -2          # csrc/imcodec.cc's kUnsupported; kCorrupt is -1
_ERRLEN = 256
_lock = threading.Lock()
_lib = None

Decoded = namedtuple("Decoded", ["pixels", "mode", "palette"])

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# headers of formats the port recognises but does not decode
_OTHER_FORMATS = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"BM", "BMP"),
                  (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
                  (b"\x00\x00\x00\x0cjP  \r\n\x87\n", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"))


def _build():
    digest = hashlib.sha256(" ".join(_FLAGS).encode()
                            + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmxtt_imcodec_{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        try:
            proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o",
                                   str(tmp)], capture_output=True,
                                  text=True)
        except OSError as e:
            raise MXNetError(f"g++ could not be run to build the image "
                             f"codec: {e}") from e
        if proc.returncode != 0:
            raise MXNetError(f"g++ failed to build the image codec:\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    vp, i32, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    ip = ctypes.POINTER(ctypes.c_int)
    lib.MXTTJpegDecode.restype = i32
    lib.MXTTJpegDecode.argtypes = [ctypes.c_char_p, u64, vp, u64, ip, ip,
                                   ip, ctypes.c_char_p, i32]
    lib.MXTTJpegEncode.restype = ctypes.c_int64
    lib.MXTTJpegEncode.argtypes = [vp, i32, i32, i32, i32, i32, i32, vp,
                                   u64, ctypes.c_char_p, i32]
    lib.MXTTPngUnfilter.restype = i32
    lib.MXTTPngUnfilter.argtypes = [ctypes.c_char_p, u64, i32, i32, i32,
                                    i32, vp, ctypes.c_char_p, i32]
    lib.MXTTPngFilter.restype = ctypes.c_int64
    lib.MXTTPngFilter.argtypes = [vp, i32, i32, i32, vp]
    return lib


def _load():
    """The codec's library, built on the first call; raises MXNetError
    with g++'s output where it does not build."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
    return _lib


def _raise(code, err, what):
    msg = err.value.decode(errors="replace")
    if code == _UNSUPPORTED:
        raise MXNetError(f"unsupported {what}: {msg}")
    raise MXNetError(f"corrupt image data: {what}: {msg}")


def image_format(buf):
    """"jpeg" or "png" for the formats the codec decodes, the name of a
    format it recognises but does not decode, or None."""
    head = bytes(buf[:16])
    if head[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if head[:8] == _PNG_SIG:
        return "png"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WebP"
    for magic, name in _OTHER_FORMATS:
        if head.startswith(magic):
            return name
    return None


def decode(buf):
    """Encoded JPEG or PNG bytes -> `Decoded` (module docstring). Raises
    MXNetError for another format, a corrupt image or a variant the
    codec does not take."""
    buf = bytes(buf)
    fmt = image_format(buf)
    if fmt == "jpeg":
        return _decode_jpeg(buf)
    if fmt == "png":
        return _decode_png(buf)
    raise MXNetError(f"unsupported image format: {fmt or 'unrecognised'} "
                     f"(the port decodes JPEG and PNG)")


def _decode_jpeg(buf):
    lib = _load()
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.MXTTJpegDecode(buf, len(buf), None, 0, ctypes.byref(w),
                            ctypes.byref(h), ctypes.byref(c), err, _ERRLEN)
    if rc < 0:
        _raise(rc, err, "JPEG")
    shape = (h.value, w.value) if c.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    rc = lib.MXTTJpegDecode(buf, len(buf), out.ctypes.data, out.nbytes,
                            ctypes.byref(w), ctypes.byref(h),
                            ctypes.byref(c), err, _ERRLEN)
    if rc != 0:
        _raise(rc, err, "JPEG")
    return Decoded(out, "L" if c.value == 1 else "RGB", None)


# PNG colour type -> (mode, channels, bit depths taken)
_PNG_TYPES = {0: ("L", 1, (1, 2, 4, 8)), 2: ("RGB", 3, (8,)),
              3: ("P", 1, (1, 2, 4, 8)), 4: ("LA", 2, (8,)),
              6: ("RGBA", 4, (8,))}


def _decode_png(buf):
    lib = _load()
    pos, ihdr, palette, idat = 8, None, None, []
    while True:
        if pos + 8 > len(buf):
            raise MXNetError("corrupt image data: PNG: truncated before "
                             "IEND")
        length, ctype = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + length]
        crc = buf[pos + 8 + length:pos + 12 + length]
        if len(data) < length or len(crc) < 4:
            raise MXNetError(f"corrupt image data: PNG: truncated "
                             f"{ctype!r} chunk")
        if zlib.crc32(ctype + data) != struct.unpack(">I", crc)[0]:
            raise MXNetError(f"corrupt image data: PNG: bad CRC in "
                             f"{ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            if length != 13:
                raise MXNetError("corrupt image data: PNG: bad IHDR")
            ihdr = struct.unpack(">IIBBBBB", data)
        elif ihdr is None:
            raise MXNetError("corrupt image data: PNG: IHDR is not first")
        elif ctype == b"PLTE":
            if length % 3 or length > 768:
                raise MXNetError("corrupt image data: PNG: bad PLTE")
            palette = np.zeros((256, 3), np.uint8)
            palette[:length // 3] = np.frombuffer(data, np.uint8).reshape(
                -1, 3)
        elif ctype == b"IDAT":
            idat.append(data)
        elif ctype == b"IEND":
            break
    w, h, depth, color, method, filt, interlace = ihdr
    if color not in _PNG_TYPES or method != 0 or filt != 0 or w == 0 \
            or h == 0:
        raise MXNetError(f"corrupt image data: PNG: bad IHDR {ihdr}")
    mode, ch, depths = _PNG_TYPES[color]
    if depth == 16:
        raise MXNetError("unsupported PNG: 16-bit samples")
    if depth not in depths:
        raise MXNetError(f"corrupt image data: PNG: bit depth {depth} "
                         f"with colour type {color}")
    if interlace:
        raise MXNetError("unsupported PNG: interlaced (Adam7)")
    if mode == "P" and palette is None:
        raise MXNetError("corrupt image data: PNG: palette image without "
                         "PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise MXNetError(f"corrupt image data: PNG: {e}") from e
    out = np.empty((h, w, ch), np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.MXTTPngUnfilter(raw, len(raw), w, h, depth, ch,
                             out.ctypes.data, err, _ERRLEN)
    if rc != 0:
        _raise(rc, err, "PNG")
    if mode == "L" and depth < 8:
        out *= np.uint8(255 // ((1 << depth) - 1))
    if ch == 1:
        out = out[:, :, 0]
    return Decoded(out, mode, palette)


def _luma24(rgb):
    """PIL's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    rgb = rgb.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470
             + rgb[..., 2] * 7471 + 0x8000) >> 16).astype(np.uint8)


def convert(d, mode):
    """A decoded image in `mode` "L" (H, W) or "RGB" (H, W, 3), by PIL's
    conversions: grey replicated to RGB, alpha dropped, a palette looked
    up, RGB to grey by ITU-R 601 in PIL's fixed point."""
    px, src = d.pixels, d.mode
    if mode == "RGB":
        if src == "RGB":
            return px
        if src == "RGBA":
            return np.ascontiguousarray(px[..., :3])
        if src == "P":
            return d.palette[px]
        grey = px if src == "L" else px[..., 0]
        return np.repeat(grey[..., None], 3, axis=2)
    if mode == "L":
        if src == "L":
            return px
        if src == "LA":
            return np.ascontiguousarray(px[..., 0])
        if src == "P":
            return _luma24(d.palette)[px]
        return _luma24(px)
    raise MXNetError(f"convert: mode {mode!r} (use 'L' or 'RGB')")


def _pixels(img):
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in (1, 2, 3, 4) \
            or min(img.shape[:2]) < 1:
        raise MXNetError(f"cannot encode an image of shape {img.shape}")
    return img


def encode_jpeg(img, quality=95, sampling=(2, 2)):
    """HW or HWC (1 or 3 channels) uint8 -> baseline JPEG bytes at
    libjpeg's `quality`; colour images take luma sampling `sampling`
    (horizontal, vertical) against 1x1 chroma: (2, 2) is 4:2:0."""
    lib = _load()
    img = _pixels(img)
    h, w, c = img.shape
    if c not in (1, 3):
        raise MXNetError(f"JPEG takes 1 or 3 channels, not {c}")
    hs, vs = sampling
    blocks = -(-w // 16) * -(-h // 16) * 4 * c
    out = np.empty(4096 + blocks * 420, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = lib.MXTTJpegEncode(img.ctypes.data, w, h, c, int(quality), hs, vs,
                           out.ctypes.data, out.nbytes, err, _ERRLEN)
    if n < 0:
        _raise(n, err, "JPEG encode")
    return out[:n].tobytes()


def _chunk(ctype, data):
    return (struct.pack(">I", len(data)) + ctype + data
            + struct.pack(">I", zlib.crc32(ctype + data)))


def encode_png(img, level=6):
    """HW or HWC (1-4 channels: grey, grey+alpha, RGB, RGBA) uint8 ->
    8-bit PNG bytes; each row's filter chosen by the least sum of its
    bytes read as signed, then deflated at `level`."""
    lib = _load()
    img = _pixels(img)
    h, w, c = img.shape
    filtered = np.empty(h * (1 + w * c), np.uint8)
    lib.MXTTPngFilter(img.ctypes.data, w, h, c, filtered.ctypes.data)
    color = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), level))
            + _chunk(b"IEND", b""))
