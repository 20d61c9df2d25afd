"""libjpeg-turbo 3.1.3's encoder (the libjpeg that Pillow 12.1 bundles in
pillow.libs/) driven through ctypes, for the codings Pillow's `save` does
not expose: arithmetic coding (SOF9, SOF10 with `progressive`), lossless
frames (SOF3: `jpeg_enable_lossless(psv, pt)`), DAC conditioning, a scan
script of its own, any sampling factors, restart intervals, and the colour
space, markers and component IDs written.

`jpeg_compress_struct` is read at the offsets below (ABI 62, LP64, taken
from that ABI's jpeglib.h); each field is checked against
`jpeg_set_defaults`'s value before it is written. libjpeg's default
`error_exit` ends the process, so every file is written in a child process
(one for a batch of files, a new one after a refusal): an encoder error
never reaches the caller's process, it comes back as EncodeError."""
from __future__ import annotations

import ctypes
import glob
import importlib.util
import pickle
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np

# byte offsets into jpeg_compress_struct (libjpeg ABI 62, LP64)
STRUCT_SIZE = 520
IMAGE_WIDTH, IMAGE_HEIGHT, INPUT_COMPONENTS, IN_COLOR_SPACE = 48, 52, 56, 60
NUM_COMPONENTS, COMP_INFO = 76, 88
ARITH_DC_L, ARITH_DC_U, ARITH_AC_K = 192, 208, 224
NUM_SCANS, SCAN_INFO, ARITH_CODE, OPTIMIZE_CODING = 240, 248, 260, 264
RESTART_INTERVAL, RESTART_IN_ROWS = 280, 284
WRITE_JFIF_HEADER, WRITE_ADOBE_MARKER = 288, 300
ERROR_MGR_SIZE = 168
# jpeg_component_info (96 bytes): component_id +0, h_samp_factor +8,
# v_samp_factor +12, quant_tbl_no +16
COMP_SIZE, COMP_ID, COMP_H, COMP_V, COMP_TQ = 96, 0, 8, 12, 16
# J_COLOR_SPACE
SPACES = {"gray": 1, "rgb": 2, "ycc": 3, "cmyk": 4, "ycck": 5}


class EncodeError(RuntimeError):
    """libjpeg refused the parameters (its message)."""


def _library():
    spec = importlib.util.find_spec("PIL")
    libs = Path(spec.origin).resolve().parents[1] / "pillow.libs"
    found = glob.glob(str(libs / "libjpeg-*.so.62.*"))
    if not found:
        raise FileNotFoundError(f"no libjpeg in {libs}")
    lib = ctypes.CDLL(found[0])
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.jpeg_std_error.restype = vp
    lib.jpeg_std_error.argtypes = [vp]
    lib.jpeg_CreateCompress.argtypes = [vp, i, ctypes.c_size_t]
    lib.jpeg_mem_dest.argtypes = [vp, vp, vp]
    for f in ("jpeg_set_defaults", "jpeg_simple_progression",
              "jpeg_finish_compress", "jpeg_destroy_compress"):
        getattr(lib, f).argtypes = [vp]
    lib.jpeg_set_colorspace.argtypes = [vp, i]
    lib.jpeg_set_quality.argtypes = [vp, i, i]
    lib.jpeg_enable_lossless.argtypes = [vp, i, i]
    lib.jpeg_start_compress.argtypes = [vp, i]
    lib.jpeg_write_scanlines.restype = ctypes.c_uint
    lib.jpeg_write_scanlines.argtypes = [vp, vp, ctypes.c_uint]
    return lib


class _Struct:
    """Typed views of the compress struct's bytes."""

    def __init__(self, buf):
        self.buf = buf
        self.addr = ctypes.addressof(buf)

    def get(self, off, ctype=ctypes.c_int):
        return ctype.from_address(self.addr + off).value

    def set(self, off, value, ctype=ctypes.c_int, default=None):
        if default is not None and self.get(off, ctype) != default:
            raise AssertionError(f"jpeg_compress_struct+{off} is "
                                 f"{self.get(off, ctype)}, not the default "
                                 f"{default}: another layout")
        ctype.from_address(self.addr + off).value = value

    def comp(self, ci, off):
        return self.get(COMP_INFO, ctypes.c_void_p) + ci * COMP_SIZE + off


def _encode_one(lib, a, *, quality=75, space=None, arith=False,
                progressive=False, lossless=None, scans=None, restart=0,
                restart_rows=0, dac=None, sampling=None, ids=None,
                jfif=None, adobe=None, optimize=False):
    a = np.ascontiguousarray(a, dtype=np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, nc = a.shape
    space = space or {1: "gray", 3: "ycc", 4: "cmyk"}[nc]
    err = ctypes.create_string_buffer(ERROR_MGR_SIZE)
    cbuf = ctypes.create_string_buffer(STRUCT_SIZE)
    s = _Struct(cbuf)
    s.set(0, lib.jpeg_std_error(err), ctypes.c_void_p)
    lib.jpeg_CreateCompress(cbuf, 62, STRUCT_SIZE)
    out, size = ctypes.c_void_p(), ctypes.c_ulong()
    lib.jpeg_mem_dest(cbuf, ctypes.byref(out), ctypes.byref(size))
    s.set(IMAGE_WIDTH, w, ctypes.c_uint)
    s.set(IMAGE_HEIGHT, h, ctypes.c_uint)
    s.set(INPUT_COMPONENTS, nc)
    # the input is taken as already in the file's colour space: no
    # conversion on the way in
    s.set(IN_COLOR_SPACE, SPACES[space])
    lib.jpeg_set_defaults(cbuf)
    lib.jpeg_set_colorspace(cbuf, SPACES[space])
    lib.jpeg_set_quality(cbuf, quality, 0)
    if s.get(NUM_COMPONENTS) != nc:
        raise AssertionError("component count differs from the input's")
    if arith:
        s.set(ARITH_CODE, 1, default=0)
    if optimize:
        s.set(OPTIMIZE_CODING, 1, default=0)
    if restart:
        s.set(RESTART_INTERVAL, restart, ctypes.c_uint, default=0)
    if restart_rows:
        s.set(RESTART_IN_ROWS, restart_rows, default=0)
    for off, key, default in ((ARITH_DC_L, "L", 0), (ARITH_DC_U, "U", 1),
                              (ARITH_AC_K, "K", 5)):
        for t, v in enumerate((dac or {}).get(key, ())):
            s.set(off + t, v, ctypes.c_uint8, default=default)
    defaults = {"ycc": [(2, 2), (1, 1), (1, 1)],
                "ycck": [(2, 2), (1, 1), (1, 1), (2, 2)]}.get(space,
                                                              [(1, 1)] * nc)
    for ci, (hv, dv) in enumerate(sampling or ()):
        s.set(s.comp(ci, COMP_H) - s.addr, hv, default=defaults[ci][0])
        s.set(s.comp(ci, COMP_V) - s.addr, dv, default=defaults[ci][1])
    for ci, cid in enumerate(ids or ()):
        s.set(s.comp(ci, COMP_ID) - s.addr, cid)
    if jfif is not None:
        s.set(WRITE_JFIF_HEADER, int(jfif))
    if adobe is not None:
        s.set(WRITE_ADOBE_MARKER, int(adobe))
    script = None
    if progressive:
        lib.jpeg_simple_progression(cbuf)
    if scans is not None:
        # (component indices, Ss, Se, Ah, Al) each: jpeg_scan_info
        script = (ctypes.c_int * (9 * len(scans)))()
        for k, (comps, ss, se, ah, al) in enumerate(scans):
            rec = [len(comps), *comps, *[0] * (4 - len(comps)), ss, se, ah,
                   al]
            script[9 * k:9 * k + 9] = rec
        s.set(NUM_SCANS, len(scans))
        s.set(SCAN_INFO, ctypes.addressof(script), ctypes.c_void_p)
    if lossless is not None:
        lib.jpeg_enable_lossless(cbuf, *lossless)
    lib.jpeg_start_compress(cbuf, 1)
    rows = (ctypes.c_void_p * h)(*[a.ctypes.data + y * w * nc
                                   for y in range(h)])
    done = 0
    while done < h:
        done += lib.jpeg_write_scanlines(
            cbuf, ctypes.byref(rows, done * ctypes.sizeof(ctypes.c_void_p)),
            h - done)
    lib.jpeg_finish_compress(cbuf)
    blob = ctypes.string_at(out, size.value)
    lib.jpeg_destroy_compress(cbuf)
    ctypes.CDLL(None).free(out)
    del script
    return blob


def _child():
    """Reads a pickled list of (array, options) on stdin and writes each
    file, length-prefixed, to stdout as soon as it is written."""
    jobs = pickle.loads(sys.stdin.buffer.read())
    lib = _library()
    for a, kw in jobs:
        blob = _encode_one(lib, a, **kw)
        sys.stdout.buffer.write(struct.pack("<Q", len(blob)) + blob)
        sys.stdout.buffer.flush()


def encode_many(jobs):
    """The file of each (array, options) job, or the EncodeError libjpeg
    raised for it. Options: `quality`, `space` ("gray", "rgb", "ycc",
    "cmyk", "ycck": the file's colour space, which the samples are already
    in), `arith`, `progressive` (jpeg_simple_progression), `lossless` ((psv,
    pt)), `scans` ((component indices, Ss, Se, Ah, Al) each), `restart` (in
    MCUs), `restart_rows`, `dac` ({"L": [...], "U": [...], "K": [...]} by
    table), `sampling` ([(h, v), ...]), `ids`, `jfif`, `adobe`,
    `optimize`."""
    jobs = [(np.asarray(a), kw) for a, kw in jobs]
    results = []
    while len(results) < len(jobs):
        rest = jobs[len(results):]
        proc = subprocess.run([sys.executable, __file__],
                              input=pickle.dumps(rest), capture_output=True)
        data, pos = proc.stdout, 0
        while pos + 8 <= len(data):
            (n,) = struct.unpack_from("<Q", data, pos)
            results.append(data[pos + 8:pos + 8 + n])
            pos += 8 + n
        if len(results) < len(jobs):
            if proc.returncode == 0:
                raise RuntimeError("the encoder process stopped early")
            msg = proc.stderr.decode(errors="replace").strip()
            results.append(EncodeError(msg.splitlines()[-1] if msg
                                       else f"exit {proc.returncode}"))
    return results


def encode(a, **kw) -> bytes:
    """One file (see encode_many); raises EncodeError on a refusal."""
    (got,) = encode_many([(a, kw)])
    if isinstance(got, Exception):
        raise got
    return got


if __name__ == "__main__":
    _child()
