"""RecordIO: the reference's binary record container (counterpart of
`mxnet_tpu/recordio.py`; reference: python/mxnet/recordio.py +
dmlc-core/src/recordio.cc).

The bytes on disk are the reference's and the JAX package's, so a .rec /
.idx pair written by either package reads in the other:

  record  := [uint32 kMagic][uint32 lrec][payload][pad to 4 bytes]
  lrec    := (cflag << 29) | length        (little-endian)
  cflag   := 0 whole record; 1/2/3 begin/middle/end of a multi-part record
             (payloads >= 2^29 - 1 bytes are split, as in dmlc-core)

`IRHeader` + `pack` / `unpack` implement the image-record convention
(flag, a float label or `flag` float labels, id, id2). `pack_img` /
`unpack_img` encode and decode image payloads, JPEG or PNG, with the
port's own codec (`_imcodec`, `csrc/imcodec.cc`): no PIL.

`MXIndexedRecordIO` adds the `.idx` sidecar (``key\\tbyte-offset\\n``
lines) for random access. Record IO is host work: the card sees these
bytes only once a batch is copied to it. The sequential and packing
classes are Python; the random-access path (`open_record_file` /
`NativeRecordFile`) is the port's own copy of the JAX package's C++ mmap
reader, `csrc/recordio.cc`, built with g++ at first use into the
gitignored `_build/` under a name that hashes the source and flags.
Where it does not build, `open_record_file` scans the file in Python
instead, with the same records.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import _imcodec
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader",
           "pack", "unpack", "pack_img", "unpack_img",
           "NativeRecordFile", "open_record_file"]

_kMagic = 0xced7230a
_LEN_MASK = (1 << 29) - 1
_MAX_CHUNK = _LEN_MASK - 1


def _lrec(cflag, length):
    return (cflag << 29) | length


class MXRecordIO:
    """Sequential .rec reader / writer (reference: MXRecordIO).

    Writes are pushed onto the dependency engine against the file's var
    (`engine.file_var`): framing happens on the caller, the disk append
    runs on a worker in program order; readers and close() wait on the
    var, so a write then a read of the same path needs no global sync."""

    def __init__(self, uri, flag):
        if flag not in ("r", "w"):
            raise MXNetError(f"invalid flag {flag!r}: use 'r' or 'w'")
        self.uri = uri
        self.flag = flag
        self.is_open = False
        from . import engine
        self._engine = engine
        self._fvar = engine.file_var(uri)
        self.open()

    def open(self):
        if self.flag == "r":
            # after any append to this path still in flight
            self._engine.wait_for_var(self._fvar)
        self.fp = open(self.uri, "rb" if self.flag == "r" else "wb")
        self._wpos = 0
        self.is_open = True

    def close(self):
        if self.is_open:
            if self.flag == "w":
                self._engine.wait_for_var(self._fvar)  # drain the appends
            self.fp.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def tell(self):
        """Write mode: the logical offset (appends may not have reached
        the file yet); read mode: the file's position."""
        return self._wpos if self.flag == "w" else self.fp.tell()

    def write(self, buf):
        """Append one record (bytes). The framing happens here, so the
        offsets the .idx records are known at once; the append runs on
        the engine, in order for this file."""
        if self.flag != "w":
            raise MXNetError("record file opened for reading")
        n = len(buf)
        if n <= _MAX_CHUNK:
            chunks = [(0, buf)]
        else:  # multi-part framing, as dmlc-core does
            parts = [buf[i:i + _MAX_CHUNK] for i in range(0, n, _MAX_CHUNK)]
            chunks = [(1, parts[0])]
            chunks += [(2, p) for p in parts[1:-1]]
            chunks.append((3, parts[-1]))
        framed = []
        for cflag, part in chunks:
            framed.append(struct.pack("<II", _kMagic,
                                      _lrec(cflag, len(part))))
            framed.append(part)
            pad = (4 - len(part) % 4) % 4
            if pad:
                framed.append(b"\x00" * pad)
        blob = b"".join(framed)
        self._wpos += len(blob)
        fp = self.fp
        self._engine.push(lambda: fp.write(blob), write_vars=[self._fvar])

    def read(self):
        """The next record, or None at the end of the file."""
        if self.flag != "r":
            raise MXNetError("record file opened for writing")
        out = []
        while True:
            header = self.fp.read(8)
            if len(header) < 8:
                if out:
                    raise MXNetError("truncated multi-part record")
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                raise MXNetError(f"invalid record magic {magic:#x} in "
                                 f"{self.uri}")
            cflag, length = lrec >> 29, lrec & _LEN_MASK
            data = self.fp.read(length)
            if len(data) < length:
                raise MXNetError("truncated record payload")
            pad = (4 - length % 4) % 4
            if pad:
                self.fp.read(pad)
            if cflag == 0:
                return data
            out.append(data)
            if cflag == 3:
                return b"".join(out)


class MXIndexedRecordIO(MXRecordIO):
    """.rec + .idx random-access pair (reference: MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = collections.OrderedDict()
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        self.idx[key_type(parts[0])] = int(parts[1])

    @property
    def keys(self):
        return list(self.idx.keys())

    def close(self):
        if self.is_open and self.flag == "w":
            with open(self.idx_path, "w") as f:
                for k, pos in self.idx.items():
                    f.write(f"{k}\t{pos}\n")
        super().close()

    def seek(self, idx):
        if idx not in self.idx:
            raise MXNetError(f"key {idx} not in index")
        self.fp.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.write(buf)


IRHeader = collections.namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """IRHeader + payload bytes -> record bytes. flag > 0 means the label
    is a (flag,)-float array stored after the fixed header."""
    header = IRHeader(*header)
    if header.flag > 0:
        label = np.asarray(header.label, dtype=np.float32)
        if label.size != header.flag:
            raise MXNetError(f"label size {label.size} != flag {header.flag}")
        header = header._replace(label=0.0)
        return struct.pack(_IR_FORMAT, *header) + label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    """record bytes -> (IRHeader, payload bytes)."""
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """IRHeader + HWC uint8 image -> record bytes: a baseline JPEG at
    libjpeg's `quality` (4:2:0 for colour, as PIL and libjpeg default)
    for `img_fmt` ".jpg" / ".jpeg", a PNG otherwise, both by the port's
    own codec (`_imcodec`; the JAX package encodes with PIL, the
    reference with cv2.imencode)."""
    img = np.asarray(img, dtype=np.uint8)
    if img_fmt.lower() in (".jpg", ".jpeg"):
        return pack(header, _imcodec.encode_jpeg(img, quality))
    return pack(header, _imcodec.encode_png(img))


def unpack_img(s, iscolor=-1):
    """record bytes -> (IRHeader, uint8 ndarray): `iscolor` 0 grey (H,
    W), 1 RGB (H, W, 3), -1 the image's own mode (grey (H, W), RGB,
    RGBA, grey+alpha, or a palette image's indices), as PIL gives them."""
    header, payload = unpack(s)
    img = _imcodec.decode(payload)
    if iscolor == 0:
        return header, _imcodec.convert(img, "L")
    if iscolor == 1:
        return header, _imcodec.convert(img, "RGB")
    return header, img.pixels


# ---------------------------------------------------------------------------
# the native reader (csrc/recordio.cc): mmap + an offset index built once,
# records copied out of the map on access
# ---------------------------------------------------------------------------
_SRC = Path(__file__).resolve().parent / "csrc" / "recordio.cc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
_native_lock = threading.Lock()
_native_lib = None
_native_tried = False


def _build_native():
    digest = hashlib.sha256(" ".join(_FLAGS).encode()
                            + _SRC.read_bytes()).hexdigest()[:16]
    out = _BUILD_DIR / f"libmxtt_recordio_{digest}.so"
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp{os.getpid()}")
        proc = subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise MXNetError(f"g++ failed to build the RecordIO reader:\n"
                             f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    lib.MXTPURecOpen.restype = ctypes.c_void_p
    lib.MXTPURecOpen.argtypes = [ctypes.c_char_p]
    lib.MXTPURecCount.restype = ctypes.c_int64
    lib.MXTPURecCount.argtypes = [ctypes.c_void_p]
    lib.MXTPURecGet.restype = ctypes.c_int
    lib.MXTPURecGet.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
                                ctypes.POINTER(ctypes.c_uint64)]
    lib.MXTPURecGetCopy.restype = ctypes.c_int64
    lib.MXTPURecGetCopy.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_uint64]
    lib.MXTPURecClose.argtypes = [ctypes.c_void_p]
    return lib


def _load_native():
    """The reader's library, built on the first call, or None where g++
    fails (the Python scan serves then)."""
    global _native_lib, _native_tried
    with _native_lock:
        if not _native_tried:
            _native_tried = True
            try:
                _native_lib = _build_native()
            except (MXNetError, OSError):
                _native_lib = None
    return _native_lib


class NativeRecordFile:
    """Random-access view of a whole .rec through the native mmap reader.
    Returns bytes (copied out of the map, safe to keep; concurrent reads
    from engine workers are safe). Raises MXNetError where the library
    does not build or the file does not parse; `open_record_file` then
    reads it in Python."""

    def __init__(self, path):
        from . import engine
        engine.wait_for_var(engine.file_var(path))  # after any writer
        lib = _load_native()
        if lib is None:
            raise MXNetError("native recordio unavailable")
        self._lib = lib
        self._h = lib.MXTPURecOpen(str(path).encode())
        if not self._h:
            raise MXNetError(f"native recordio failed to open {path}")
        self._n = lib.MXTPURecCount(self._h)

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        if i < 0:
            i += self._n
        ptr = ctypes.POINTER(ctypes.c_uint8)()
        ln = ctypes.c_uint64()
        rc = self._lib.MXTPURecGet(self._h, i, ctypes.byref(ptr),
                                   ctypes.byref(ln))
        if rc == 0:
            return ctypes.string_at(ptr, ln.value)
        if rc == 1:  # multi-part: stitched into a buffer
            size = self._lib.MXTPURecGetCopy(self._h, i, None, 0)
            buf = ctypes.create_string_buffer(size)
            if self._lib.MXTPURecGetCopy(self._h, i, buf, size) != size:
                raise MXNetError("native recordio copy failed")
            return buf.raw
        raise IndexError(i)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.MXTPURecClose(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_record_file(path):
    """Random-access reader for a .rec: the native mmap reader where the
    C++ library builds, else a Python scan into a list of bytes."""
    try:
        return NativeRecordFile(path)
    except MXNetError:
        records = []
        r = MXRecordIO(path, "r")
        while True:
            item = r.read()
            if item is None:
                break
            records.append(item)
        r.close()
        return records
