"""`mxnet_tpu_torch.recordio` and `gluon.data.RecordFileDataset` against
the JAX package: the same records give the same .rec / .idx bytes,
either package reads the other's files, multi-part records, and the
native (`csrc/recordio.cc`) and Python readers."""
import struct
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu.recordio as jrio
import mxnet_tpu_torch as mx
import mxnet_tpu_torch.recordio as rio
from mxnet_tpu_torch.base import MXNetError


def _records(seed=0, n=9):
    """Seeded payloads of several lengths (0 and every padding case), a
    plain header and a multi-label one."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        body = rng.randint(0, 256, size=int(rng.randint(0, 40))).astype(
            np.uint8).tobytes()
        if i % 3 == 0:
            head = (2, np.array([i, -i], np.float32), i, 7)
        else:
            head = (0, float(i) * 0.5, i, 0)
        out.append((head, body))
    return out


def _write(pkg, tmp_path, tag, records, indexed=True):
    rec_p, idx_p = str(tmp_path / f"{tag}.rec"), str(tmp_path / f"{tag}.idx")
    if indexed:
        w = pkg.MXIndexedRecordIO(idx_p, rec_p, "w")
        for i, (head, body) in enumerate(records):
            w.write_idx(i, pkg.pack(pkg.IRHeader(*head), body))
    else:
        w = pkg.MXRecordIO(rec_p, "w")
        for head, body in records:
            w.write(pkg.pack(pkg.IRHeader(*head), body))
    w.close()
    return rec_p, idx_p


@pytest.mark.parametrize("indexed", [True, False])
def test_rec_and_idx_bytes_equal_the_jax_packages(tmp_path, indexed):
    """The same records written by each package: byte-identical files."""
    recs = _records()
    a_rec, a_idx = _write(rio, tmp_path, "port", recs, indexed)
    b_rec, b_idx = _write(jrio, tmp_path, "jax", recs, indexed)
    jmx.engine.wait_for_all()
    assert open(a_rec, "rb").read() == open(b_rec, "rb").read()
    if indexed:
        assert open(a_idx).read() == open(b_idx).read()


@pytest.mark.parametrize("writer,reader", [(rio, jrio), (jrio, rio)],
                         ids=["port-to-jax", "jax-to-port"])
def test_each_package_reads_the_others_files(tmp_path, writer, reader):
    """Written by one package, read sequentially, by key and through
    `unpack` by the other: the same headers and payloads."""
    recs = _records(1)
    rec_p, idx_p = _write(writer, tmp_path, "x", recs)
    jmx.engine.wait_for_all()
    r = reader.MXIndexedRecordIO(idx_p, rec_p, "r")
    assert r.keys == list(range(len(recs)))
    for i in (4, 0, 8, 3):
        head, body = reader.unpack(r.read_idx(i))
        assert body == recs[i][1]
        assert head.id == i and head.flag == recs[i][0][0]
        np.testing.assert_array_equal(np.asarray(head.label, np.float32),
                                      np.asarray(recs[i][0][1], np.float32))
    r.reset()
    got = []
    while True:
        item = r.read()
        if item is None:
            break
        got.append(reader.unpack(item)[1])
    assert got == [b for _, b in recs]
    r.close()


def test_framing_matches_the_reference_format(tmp_path):
    path = str(tmp_path / "a.rec")
    w = rio.MXRecordIO(path, "w")
    w.write(b"abcde")  # 5 bytes -> 3 pad
    w.close()
    blob = open(path, "rb").read()
    magic, lrec = struct.unpack("<II", blob[:8])
    assert magic == 0xced7230a
    assert lrec >> 29 == 0 and (lrec & ((1 << 29) - 1)) == 5
    assert blob[8:13] == b"abcde" and len(blob) == 16


@pytest.fixture
def small_chunks(monkeypatch):
    """A 16-byte chunk limit in both packages, so that multi-part framing
    shows at a small size."""
    monkeypatch.setattr(rio, "_MAX_CHUNK", 16)
    monkeypatch.setattr(jrio, "_MAX_CHUNK", 16)


def test_multi_part_records_match_and_read_both_ways(tmp_path, small_chunks):
    """cflag 1 / 2 / 3 framing: the same bytes as the JAX package, and
    the native and Python readers of both packages stitch the parts."""
    payloads = [b"short", bytes(range(200)), b"x" * 63, b"", b"y" * 16,
                b"z" * 17]
    paths = []
    for pkg, tag in ((rio, "port"), (jrio, "jax")):
        path = str(tmp_path / f"{tag}.rec")
        w = pkg.MXRecordIO(path, "w")
        for p in payloads:
            w.write(p)
        w.close()
        paths.append(path)
    jmx.engine.wait_for_all()
    blob = open(paths[0], "rb").read()
    assert blob == open(paths[1], "rb").read()
    assert struct.unpack("<II", blob[16:24])[1] >> 29 == 1   # multi-part
    for path in paths:
        r = rio.MXRecordIO(path, "r")
        assert [r.read() for _ in payloads] == payloads
        assert r.read() is None
        r.close()
        native = rio.NativeRecordFile(path)
        assert len(native) == len(payloads)
        assert [native[i] for i in range(len(payloads))] == payloads
        assert native[-1] == payloads[-1]
        native.close()
        assert list(jrio.open_record_file(path)) == payloads


def test_native_reader_builds_and_serves(tmp_path):
    """g++ builds `csrc/recordio.cc` into `_build/`; `open_record_file`
    then returns the native reader, and without it (a failed build) the
    Python scan, with the same records."""
    assert rio._load_native() is not None
    recs = _records(2)
    rec_p, _ = _write(rio, tmp_path, "n", recs, indexed=False)
    rf = rio.open_record_file(rec_p)
    assert isinstance(rf, rio.NativeRecordFile)
    with pytest.raises(IndexError):
        rf[len(recs)]
    scanned = None
    saved = (rio._native_lib, rio._native_tried)
    try:
        rio._native_lib, rio._native_tried = None, True
        scanned = rio.open_record_file(rec_p)
    finally:
        rio._native_lib, rio._native_tried = saved
    assert isinstance(scanned, list)
    assert [rf[i] for i in range(len(rf))] == scanned
    assert [rio.unpack(s)[1] for s in scanned] == [b for _, b in recs]


def test_torn_files_end_or_raise(tmp_path):
    """A truncated .rec ends cleanly (a cut header) or raises MXNetError
    (a cut payload) in the Python reader; the native reader refuses it."""
    path = str(tmp_path / "t.rec")
    w = rio.MXRecordIO(path, "w")
    for i in range(5):
        w.write(b"payload-%d" % i * 10)
    w.close()
    raw = open(path, "rb").read()
    bad = str(tmp_path / "bad.rec")
    for cut in (1, 7, len(raw) // 3, len(raw) - 3):
        open(bad, "wb").write(raw[:cut])
        try:
            r = rio.MXRecordIO(bad, "r")
            n = 0
            while r.read() is not None:
                n += 1
            assert n <= 5
        except MXNetError:
            pass
        with pytest.raises(MXNetError):
            rio.NativeRecordFile(bad)


def test_pack_unpack_match_the_jax_package():
    for head, body in _records(3):
        a = rio.pack(rio.IRHeader(*head), body)
        assert a == jrio.pack(jrio.IRHeader(*head), body)
        h, b = rio.unpack(a)
        assert b == body and h.id == head[2]
    with pytest.raises(MXNetError, match="label size"):
        rio.pack(rio.IRHeader(3, [1.0, 2.0], 0, 0), b"")


def test_pack_img_names_pil_where_missing(monkeypatch):
    """Without PIL, pack_img / unpack_img work (the port's own codec,
    since [6c]): a PNG record round-trips bit for bit, a JPEG one to its
    shape; an empty payload raises MXNetError, naming no PIL."""
    img = (np.random.RandomState(2).rand(6, 5, 3) * 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    head = rio.IRHeader(0, 1.0, 5, 0)
    h, back = rio.unpack_img(rio.pack_img(head, img, img_fmt=".png"))
    assert h.id == 5
    np.testing.assert_array_equal(back, img)
    _, back = rio.unpack_img(rio.pack_img(head, img, quality=90))
    assert back.shape == img.shape and back.dtype == np.uint8
    with pytest.raises(MXNetError, match="unrecognised") as err:
        rio.unpack_img(rio.pack(head, b""))
    assert "PIL" not in str(err.value)


def test_pack_img_matches_the_jax_package():
    """PNG records equal the JAX package's and decode to the image."""
    pytest.importorskip("PIL")
    img = (np.random.RandomState(0).rand(12, 10, 3) * 255).astype(np.uint8)
    head = rio.IRHeader(0, 1.0, 5, 0)
    s = rio.pack_img(head, img, img_fmt=".png")
    assert s == jrio.pack_img(jrio.IRHeader(*head), img, img_fmt=".png")
    h, back = rio.unpack_img(s, iscolor=1)
    assert h.id == 5
    np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("index", ["full", "none", "partial"])
def test_record_file_dataset_matches_the_jax_packages(tmp_path, index):
    """`RecordFileDataset` over the same pack: the JAX package's items in
    its order, through the native reader where the .idx lists every
    record (or there is none), through the index (`_rec`) otherwise."""
    recs = _records(4, n=12)
    rec_p, idx_p = _write(rio, tmp_path, "d", recs)
    if index == "none":
        import os
        os.remove(idx_p)
    elif index == "partial":
        lines = open(idx_p).read().splitlines()
        with open(idx_p, "w") as f:
            f.write("\n".join(lines[::-2]) + "\n")
    ds = mx.gluon.data.RecordFileDataset(rec_p)
    ref = jmx.gluon.data.RecordFileDataset(rec_p)
    assert len(ds) == len(ref)
    assert [ds[i] for i in range(len(ds))] == \
        [ref[i] for i in range(len(ref))]
    assert ds[-1] == ref[len(ref) - 1]
    assert isinstance(ds._records, rio.NativeRecordFile)
    assert (ds._rec is None) == (index != "partial")
