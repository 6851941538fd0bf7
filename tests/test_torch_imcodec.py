"""The port's image codec (`mxnet_tpu_torch/_imcodec.py`,
`csrc/imcodec.cc`) against PIL, which this machine has and the card's
does not: JPEG decodes within one level of PIL's (libjpeg-turbo's), PNG
decodes bit for bit, the port's JPEG encodes within 0.5 dB PSNR and 10 %
size of PIL's at the same quality, and what the codec does not take
raises `MXNetError` naming it."""
import io
import struct
import zlib

import numpy as np
import pytest

from mxnet_tpu_torch import _imcodec as codec
from mxnet_tpu_torch.base import MXNetError

Image = pytest.importorskip("PIL.Image")

JPEG_LEVELS = 1          # max |port - PIL| a sample, JPEG decode
PSNR_DB = 0.5            # port encode against PIL's, same quality
SIZE_REL = 0.10


def smooth_image(h, w, seed, c=3):
    """Six sinusoids a channel plus N(0, 6) noise: the content of a
    natural photo's JPEG more than uniform noise is."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((h, w, c), 128.0, np.float32)
    for ch in range(c):
        for _ in range(6):
            fx, fy = rng.uniform(0.005, 0.08, 2)
            out[..., ch] += rng.uniform(10, 40) * np.sin(
                fx * x + fy * y + rng.uniform(0, 6.3))
    out += rng.normal(0, 6, out.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def pil_bytes(img, fmt, **kw):
    """PIL's encoding of a numpy image or a PIL image."""
    if not isinstance(img, Image.Image):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, format=fmt, **kw)
    return buf.getvalue()


def pil_decode(data):
    return np.asarray(Image.open(io.BytesIO(data)))


def _levels(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return int(d.max()), float((d == 0).mean())


SIZES = [(1, 1), (17, 33), (256, 341)]
SUBSAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2}


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_decode_matches_pil(size, quality):
    """PIL-written JPEGs at each quality, in 4:4:4, 4:2:2 and 4:2:0, with
    optimised Huffman tables and with restart markers, and grey: the
    port's pixels within JPEG_LEVELS of PIL's (the share of exact
    samples printed)."""
    img = smooth_image(*size, seed=quality)
    cases = {}
    for name, sub in SUBSAMPLING.items():
        cases[name] = pil_bytes(img, "JPEG", quality=quality,
                                subsampling=sub)
    cases["optimize"] = pil_bytes(img, "JPEG", quality=quality,
                                  optimize=True)
    cases["restarts"] = pil_bytes(img, "JPEG", quality=quality,
                                  restart_marker_blocks=2)
    cases["grey"] = pil_bytes(img[..., 1], "JPEG", quality=quality)
    for name, data in cases.items():
        d = codec.decode(data)
        want = pil_decode(data)
        assert d.pixels.shape == want.shape, name
        assert d.mode == ("L" if name == "grey" else "RGB")
        worst, exact = _levels(d.pixels, want)
        print(f"{size} q{quality} {name}: max |d| {worst}, exact "
              f"{100 * exact:.3f} %")
        assert worst <= JPEG_LEVELS, (name, worst)


@pytest.mark.parametrize("sampling", [(1, 2), (2, 1), (1, 1), (2, 2)])
def test_jpeg_decode_of_every_sampling_the_port_writes(sampling):
    """4:4:0 (luma 1x2) PIL cannot write: the port's encoder writes it,
    and the port's decode of it holds against PIL's, at sizes with
    partial MCUs on both edges and at one row and one column."""
    for size in [(17, 33), (33, 17), (1, 9), (9, 1), (2, 2)]:
        img = smooth_image(*size, seed=size[0])
        data = codec.encode_jpeg(img, 90, sampling=sampling)
        worst, _ = _levels(codec.decode(data).pixels, pil_decode(data))
        assert worst <= JPEG_LEVELS, (size, sampling, worst)


def test_jpeg_edges_stuffing_restarts_and_long_codes():
    """Noise at q100 makes FF bytes (stuffed as FF 00), long Huffman codes
    and large coefficients; restart markers every block reset the DC
    predictors; an APPn and a COM segment are skipped."""
    rng = np.random.RandomState(3)
    img = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    data = pil_bytes(img, "JPEG", quality=100, restart_marker_blocks=1,
                     optimize=True, comment=b"port codec test")
    assert b"\xff\x00" in data and b"\xff\xd0" in data and b"\xff\xfe" \
        in data
    worst, _ = _levels(codec.decode(data).pixels, pil_decode(data))
    assert worst <= JPEG_LEVELS
    # an APP1 segment spliced in after SOI changes nothing
    app1 = b"\xff\xe1" + struct.pack(">H", 12) + b"Exif\x00\x00abcd"
    spliced = data[:2] + app1 + data[2:]
    np.testing.assert_array_equal(codec.decode(spliced).pixels,
                                  codec.decode(data).pixels)


def _png_cases():
    rng = np.random.RandomState(0)
    rgb = (rng.rand(23, 37, 3) * 255).astype(np.uint8)
    quant = Image.fromarray(rgb)
    return {
        "L": Image.fromarray(rgb[..., 0]),
        "LA": Image.fromarray((rng.rand(23, 37, 2) * 255).astype(np.uint8),
                              "LA"),
        "RGB": Image.fromarray(rgb),
        "RGBA": Image.fromarray((rng.rand(23, 37, 4) * 255)
                                .astype(np.uint8)),
        "P 8-bit": quant.quantize(200),
        "P 4-bit": quant.quantize(16),
        "P 2-bit": quant.quantize(4),
        "P 1-bit": quant.quantize(2),
        "1-bit grey": Image.fromarray(rgb[..., 0]).convert("1"),
    }


@pytest.mark.parametrize("name", list(_png_cases()))
def test_png_decode_is_bit_for_bit(name):
    """Every mode the codec takes, with each filter choice PIL makes
    (default, optimize, no compression): the native pixels, and the RGB
    and grey conversions, equal PIL's bit for bit (a 1-bit image reads as
    0 / 255 grey where PIL gives booleans)."""
    im = _png_cases()[name]
    for kw in ({}, {"optimize": True}, {"compress_level": 0}):
        data = pil_bytes(im, "PNG", **kw)
        ref = Image.open(io.BytesIO(data))
        d = codec.decode(data)
        native = np.asarray(ref)
        if native.dtype == bool:
            native = native.astype(np.uint8) * 255
        np.testing.assert_array_equal(d.pixels, native)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(codec.convert(d, mode),
                                          np.asarray(ref.convert(mode)))


@pytest.mark.parametrize("shape", [(12, 10, 3), (23, 37), (5, 3, 4),
                                   (40, 40, 2), (1, 1, 3)])
def test_png_encode_round_trips_through_pil(shape):
    img = (np.random.RandomState(1).rand(*shape) * 255).astype(np.uint8)
    data = codec.encode_png(img)
    np.testing.assert_array_equal(pil_decode(data), img)
    np.testing.assert_array_equal(codec.decode(data).pixels, img)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
def test_jpeg_encode_against_pils(quality):
    """The port's JPEG, decoded by PIL: PSNR within PSNR_DB of PIL's own
    encode at the same quality, size within SIZE_REL, colour and grey."""
    img = smooth_image(256, 341, seed=7)
    for arr in (img, img[..., 0]):
        ours = codec.encode_jpeg(arr, quality)
        theirs = pil_bytes(arr, "JPEG", quality=quality)
        p_ours = _psnr(pil_decode(ours), arr)
        p_theirs = _psnr(pil_decode(theirs), arr)
        print(f"q{quality} {arr.ndim}-d: PSNR {p_ours:.3f} / {p_theirs:.3f} "
              f"dB, {len(ours)} / {len(theirs)} bytes")
        assert abs(p_ours - p_theirs) <= PSNR_DB
        assert abs(len(ours) / len(theirs) - 1) <= SIZE_REL


def _interlaced_png():
    ihdr = struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)
    idat = zlib.compress(bytes(64))

    def chunk(t, d):
        return (struct.pack(">I", len(d)) + t + d
                + struct.pack(">I", zlib.crc32(t + d)))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def test_unsupported_and_corrupt_inputs_raise():
    img = smooth_image(40, 56, seed=5)
    good = pil_bytes(img, "JPEG", quality=90)
    cases = {
        "progressive": (pil_bytes(img, "JPEG", progressive=True),
                        "progressive"),
        "CMYK": (pil_bytes(Image.fromarray(img).convert("CMYK"), "JPEG"),
                 "CMYK"),
        "truncated scan": (good[:len(good) // 2], "truncated"),
        "truncated header": (good[:40], "corrupt"),
        "garbage after SOI": (b"\xff\xd8\xff" + bytes(np.random.RandomState(
            0).randint(0, 256, 300).astype(np.uint8)), "corrupt"),
        "16-bit PNG": (pil_bytes(Image.fromarray(
            (np.arange(64).reshape(8, 8) * 1000).astype(np.uint16)),
            "PNG"), "16-bit"),
        "Adam7 PNG": (_interlaced_png(), "Adam7"),
        "truncated PNG": (codec.encode_png(img)[:100], "truncated"),
        "GIF": (b"GIF89a" + bytes(20), "GIF"),
        "unrecognised": (b"plain bytes", "unrecognised"),
    }
    for name, (data, words) in cases.items():
        with pytest.raises(MXNetError, match=words):
            codec.decode(data)
    # the truncated scan is refused without reading past the buffer:
    # every cut of the file raises or decodes, never crashes
    for cut in range(2, len(good), 97):
        try:
            codec.decode(good[:cut])
        except MXNetError:
            pass


def test_a_failed_build_raises_with_gpps_output(monkeypatch, tmp_path):
    """No fallback decoder: where g++ cannot build the codec, a decode
    raises MXNetError carrying g++'s output."""
    data = codec.encode_png(np.zeros((2, 2), np.uint8))
    bad = tmp_path / "imcodec.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(codec, "_SRC", bad)
    monkeypatch.setattr(codec, "_BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(codec, "_lib", None)
    with pytest.raises(MXNetError, match="g\\+\\+ failed to build the "
                                         "image codec:\n.*error"):
        codec.decode(data)
