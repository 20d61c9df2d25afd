"""The port's RasterReader on the formats besides TIFF, against the JAX
package's (metadata, georeferencing, every band), on the CPU:

  * netCDF classic grids (the files of tests/test_io.py's netCDF tests),
    and the netCDF-4 / HDF5 refusal;
  * PNGs that Pillow writes (8-bit gray, 16-bit gray, RGB, RGBA, gray +
    alpha, palettes at 1, 2, 4 and 8 bits) with world file, .prj and text
    chunks, which the port decodes with its own codec (io/png.py) and the
    JAX package with Pillow;
  * PNGs written here chunk by chunk for what Pillow does not write: 16-bit
    colour, grayscale at 1, 2 and 4 bits, each of the five row filters on
    every colour type and depth, Adam7 interlacing of each of them, split
    image data, text chunks after the image data;
  * what both refuse, as RasterError: broken files.
The other formats Pillow opens are held in tests/test_torch_decoders.py.
"""
import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from PIL import Image, PngImagePlugin  # noqa: E402
from sarpro_tpu.io import raster as jraster  # noqa: E402
from sarpro_tpu_torch.errors import RasterError  # noqa: E402
from sarpro_tpu_torch.io import png  # noqa: E402
from sarpro_tpu_torch.io import raster as traster  # noqa: E402
from test_io import _write_nc  # noqa: E402


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and np.array_equal(a, b))
    return type(a) is type(b) and a == b


def _readers_equal(path):
    """The port's RasterReader equals the JAX one on `path`: every
    metadata and georeferencing field, and every band. Returns the bands."""
    t, j = traster.RasterReader(path), jraster.RasterReader(path)
    try:
        for got, want in ((t.metadata, j.metadata), (t.geo, j.geo)):
            for f in dataclasses.fields(want):
                assert _same(getattr(got, f.name), getattr(want, f.name)), \
                    f.name
        bands = []
        for b in range(1, j.metadata.bands + 1):
            tb, jb = t.read_band(b), j.read_band(b)
            assert tb.dtype == jb.dtype == np.float32
            assert np.array_equal(tb, jb), b
            bands.append(tb)
        for b in (0, j.metadata.bands + 1):
            with pytest.raises(RasterError, match="out of range"):
                t.read_band(b)
        return bands
    finally:
        t.close()
        j.close()


# ---------------------------------------------------------------------------
# netCDF
# ---------------------------------------------------------------------------
WKT_32632 = (
    'PROJCS["WGS 84 / UTM zone 32N",GEOGCS["WGS 84",DATUM["WGS_1984",'
    'SPHEROID["WGS 84",6378137,298.257223563]],PRIMEM["Greenwich",0],'
    'UNIT["degree",0.0174532925199433]],PROJECTION["Transverse_Mercator"],'
    'AUTHORITY["EPSG","32632"]]')


def _nc_values(path, rng):
    a = rng.integers(0, 60000, (24, 30)).astype(np.int32)
    y = (4000000.0 - 5.0 - 10.0 * np.arange(24)).astype(np.float64)
    x = (500000.0 + 5.0 + 10.0 * np.arange(30)).astype(np.float64)
    _write_nc(path, "sigma0", a, y=y, x=x,
              global_attrs={"title": "test grid"})


def _nc_grid_mapping(path, rng):
    a = rng.random((3, 8, 10)).astype(np.float32)
    _write_nc(path, "backscatter", a, var_attrs={"grid_mapping": "crs"},
              extra_vars={"crs": (np.int32(0), (), {"spatial_ref":
                                                    WKT_32632})})


def _nc_epsg_code(path, rng):
    a = rng.integers(-300, 300, (2, 2, 5, 7)).astype(np.int16)
    _write_nc(path, "dn", a, var_attrs={"grid_mapping": "crs",
                                        "units": "dB"},
              extra_vars={"crs": (np.int32(0), (), {"epsg_code": 3857})})


def _nc_lonlat(path, rng):
    a = rng.integers(0, 255, (6, 9)).astype(np.int16)
    lat = (50.0 - 0.25 * np.arange(6)).astype(np.float64)
    lon = (10.0 + 0.25 * np.arange(9)).astype(np.float64)
    _write_nc(path, "dn", a, y=lat, x=lon, dims=("lat", "lon"))


def _nc_uneven_axis(path, rng):
    a = rng.random((5, 6)).astype(np.float64)
    y = np.array([0.0, 1.0, 3.0, 4.0, 9.0])
    x = np.arange(6, dtype=np.float64)
    _write_nc(path, "v", a, y=y, x=x)


NETCDF = {"values and geotransform": _nc_values,
          "grid mapping wkt, three bands": _nc_grid_mapping,
          "epsg code, four dimensions": _nc_epsg_code,
          "lon / lat degrees": _nc_lonlat,
          "uneven axis": _nc_uneven_axis}


@pytest.mark.parametrize("name", list(NETCDF))
def test_netcdf_equals_jax(tmp_path, rng, name):
    path = tmp_path / "g.nc"
    NETCDF[name](path, rng)
    bands = _readers_equal(path)
    assert bands


def test_netcdf_hdf5_container_rejected(tmp_path):
    p = tmp_path / "v4.nc"
    p.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\x00" * 64)
    with pytest.raises(RasterError, match="netCDF-4"):
        traster.RasterReader(p)
    with pytest.raises(jraster.RasterError, match="netCDF-4"):
        jraster.RasterReader(p)


# ---------------------------------------------------------------------------
# PNGs that Pillow writes
# ---------------------------------------------------------------------------
def _pillow_png(path, rng, kind):
    info = PngImagePlugin.PngInfo()
    info.add_text("Software", "sarpro test")
    info.add_text("note", "z" * 200, zip=True)
    info.add_itxt("Title", "Überblick", lang="de", tkey="Titel")
    info.add_itxt("packed", "ω" * 50, zip=True)
    if kind.startswith("P"):
        bits = int(kind[1:])
        a = rng.integers(0, 1 << bits, (33, 45)).astype(np.uint8)
        im = Image.fromarray(a, mode="P")
        # a short palette: indices past it read black
        im.putpalette(list(rng.integers(0, 256, 3 * max(1, (1 << bits) - 1))))
        im.save(path, format="PNG", pnginfo=info, bits=bits)
        return
    shapes = {"L": (33, 45), "RGB": (33, 45, 3), "RGBA": (21, 17, 4),
              "LA": (21, 17, 2), "I;16": (33, 45)}
    dtype = np.uint16 if kind == "I;16" else np.uint8
    a = rng.integers(0, np.iinfo(dtype).max, shapes[kind]).astype(dtype)
    Image.fromarray(a).save(path, format="PNG", pnginfo=info)


PILLOW = ("L", "I;16", "RGB", "RGBA", "LA", "P1", "P2", "P4", "P8")


@pytest.mark.parametrize("kind", PILLOW)
def test_pillow_png_equals_jax(tmp_path, rng, kind):
    path = tmp_path / "scene.png"
    _pillow_png(path, rng, kind)
    # a world file (pixel-center convention) and a .prj, as GDAL reads them
    path.with_suffix(".pgw").write_text(
        "10.0\n0.0\n0.0\n-10.0\n500005.0\n3999995.0\n")
    path.with_suffix(".prj").write_text(WKT_32632)
    _readers_equal(path)
    t = traster.RasterReader(path)
    assert t.metadata.epsg == 32632
    assert t.metadata.geotransform == [500000.0, 10.0, 0.0, 4000000.0, 0.0,
                                       -10.0]
    assert t.metadata.metadata["Software"] == "sarpro test"
    assert t.metadata.metadata["Title"] == "Überblick"
    assert t.metadata.metadata["packed"] == "ω" * 50
    assert len(t.metadata.metadata["note"]) == 200


@pytest.mark.parametrize("kind", ["L", "RGB", "P4"])
def test_pillow_png_without_sidecars_equals_jax(tmp_path, rng, kind):
    path = tmp_path / "plain.img"  # the content decides, not the name
    _pillow_png(path, rng, kind)
    _readers_equal(path)
    t = traster.RasterReader(path)
    assert t.metadata.geotransform == [0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
    assert t.metadata.epsg is None


# ---------------------------------------------------------------------------
# PNGs written chunk by chunk
# ---------------------------------------------------------------------------
def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(line: np.ndarray, prior: np.ndarray, kind: int,
              bpp: int) -> np.ndarray:
    """One scanline under row filter `kind` (the PNG spec's forward
    filters, on the unfiltered neighbours)."""
    x, up = line.astype(np.int64), prior.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, ul)}[kind]
    return ((x - pred) % 256).astype(np.uint8)


def _scanlines(arr, depth):
    """(rows, stride) u8 scanlines of a (rows, cols[, samples]) array."""
    rows = arr.shape[0]
    if depth == 16:
        return arr.astype(">u2").view(np.uint8).reshape(rows, -1)
    if depth == 8:
        return arr.astype(np.uint8).reshape(rows, -1)
    bits = ((arr.reshape(rows, -1, 1).astype(np.uint8)
             >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
    return np.packbits(bits.reshape(rows, -1), axis=1)


def _image_data(arr, depth, ctype, filters):
    samples = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    bpp = max(1, samples * depth // 8)
    lines = _scanlines(arr, depth)
    out, prior = [], np.zeros(lines.shape[1], np.uint8)
    for r, line in enumerate(lines):
        kind = filters[r % len(filters)]
        out.append(bytes([kind]) + _filtered(line, prior, kind, bpp).tobytes())
        prior = line
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _png(arr, depth, ctype, filters=(0,), palette=None, interlace=False,
         texts=(), idat_parts=1, trailing=()):
    """A PNG of `arr` (values at `depth` bits) chunk by chunk: row filters
    taken in turn from `filters`, Adam7 passes if `interlace`, the image
    data split over `idat_parts` IDAT chunks, text chunks before it and
    `trailing` chunks after it."""
    rows, cols = arr.shape[:2]
    if interlace:
        raw = b"".join(_image_data(arr[y0::dy, x0::dx], depth, ctype,
                                   filters)
                       for y0, x0, dy, dx in ADAM7
                       if arr[y0::dy, x0::dx].size)
    else:
        raw = _image_data(arr, depth, ctype, filters)
    comp = zlib.compress(raw)
    cut = [len(comp) * i // idat_parts for i in range(idat_parts + 1)]
    blob = png.SIGNATURE + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", cols, rows, depth, ctype, 0, 0, int(interlace)))
    blob += b"".join(_chunk(k, v) for k, v in texts)
    if palette is not None:
        blob += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    blob += b"".join(_chunk(b"IDAT", comp[a:b]) for a, b in zip(cut,
                                                                cut[1:]))
    blob += b"".join(_chunk(k, v) for k, v in trailing)
    return blob + _chunk(b"IEND", b"")


# (colour type, depth, samples of the array)
FORMS = {"gray 1": (0, 1, 1), "gray 2": (0, 2, 1), "gray 4": (0, 4, 1),
         "gray 8": (0, 8, 1), "gray 16": (0, 16, 1), "rgb 8": (2, 8, 3),
         "rgb 16": (2, 16, 3), "palette 1": (3, 1, 1),
         "palette 2": (3, 2, 1), "palette 4": (3, 4, 1),
         "palette 8": (3, 8, 1), "gray alpha 8": (4, 8, 2),
         "gray alpha 16": (4, 16, 2), "rgba 8": (6, 8, 4),
         "rgba 16": (6, 16, 4)}


def _form(rng, name, shape=(13, 21)):
    ctype, depth, samples = FORMS[name]
    top = (1 << depth) - 1
    arr = rng.integers(0, top + 1, shape + ((samples,) if samples > 1
                                            else ())).astype(np.uint16)
    palette = (rng.integers(0, 256, (min(1 << depth, 200), 3))
               if ctype == 3 else None)
    return arr, depth, ctype, palette


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)],
                         ids=["none", "sub", "up", "average", "paeth",
                              "mixed"])
@pytest.mark.parametrize("name", list(FORMS))
def test_filtered_png_equals_jax(tmp_path, rng, name, filters):
    arr, depth, ctype, palette = _form(rng, name)
    path = tmp_path / "f.png"
    path.write_bytes(_png(arr, depth, ctype, filters, palette))
    _readers_equal(path)
    data, _ = png.decode(path.read_bytes())
    if ctype == 0:  # Pillow's "1", "L;2" / "L;4" (x85, x17), "L", "I;16"
        want = {1: arr != 0, 2: arr * 85, 4: arr * 17}.get(depth, arr)
        assert data.dtype == {1: bool, 16: np.uint16}.get(depth, np.uint8)
        assert np.array_equal(data[..., 0], want)
    if ctype == 2 and depth == 16:  # Pillow's high byte of each sample
        assert np.array_equal(data, arr >> 8)
    if ctype == 4 and depth == 16:  # read as RGBA (L, L, L, A)
        assert np.array_equal(data, (arr >> 8)[..., [0, 0, 0, 1]])


def test_png_text_chunks_and_split_image_data_equal_jax(tmp_path, rng):
    arr, depth, ctype, palette = _form(rng, "rgb 8", (40, 33))
    texts = [(b"tEXt", b"Author\0A. Person"),
             (b"tEXt", b"no separator"),
             (b"tEXt", b"exif\0raw bytes in Pillow"),
             (b"zTXt", b"Comment\0\0" + zlib.compress(b"zipped \xe9")),
             (b"zTXt", b"broken\0\0not zlib"),
             (b"iTXt", b"Title\0\0\0en\0Title\0" + "Übersicht".encode()),
             (b"iTXt", b"Packed\0\1\0\0\0" + zlib.compress("ω".encode())),
             (b"iTXt", b"bad utf8\0\0\0\0\0\xff\xfe")]
    trailing = [(b"tEXt", b"After\0the image data"),
                (b"tEXt", b"Author\0overwritten")]
    path = tmp_path / "t.png"
    path.write_bytes(_png(arr, depth, ctype, (1, 4), texts=texts,
                          idat_parts=3, trailing=trailing))
    _readers_equal(path)
    meta = traster.RasterReader(path).metadata.metadata
    assert meta == {"Author": "overwritten", "no separator": "",
                    "Comment": "zipped é", "broken": "",
                    "Title": "Übersicht", "Packed": "ω",
                    "After": "the image data"}


def test_large_paeth_png_equals_jax(tmp_path, rng):
    """A wider image through the row loops of Average and Paeth."""
    arr = rng.integers(0, 65536, (64, 700, 3)).astype(np.uint16)
    path = tmp_path / "wide.png"
    path.write_bytes(_png(arr, 16, 2, (4, 3)))
    _readers_equal(path)


# ---------------------------------------------------------------------------
# what both refuse
# ---------------------------------------------------------------------------
def _refused(path, match):
    with pytest.raises(RasterError, match=match) as ei:
        traster.RasterReader(path)
    assert str(ei.value).startswith("unsupported raster format")


@pytest.mark.parametrize("shape", [(1, 1), (3, 2), (11, 14), (21, 30)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(FORMS))
def test_interlaced_png_equals_jax(tmp_path, rng, name, shape):
    """Adam7 at every colour type and depth (passes empty at the smallest
    sizes), each pass filtered on its own: equal to the JAX reader, and to
    the same image without interlacing."""
    arr, depth, ctype, palette = _form(rng, name, shape)
    path = tmp_path / "i.png"
    path.write_bytes(_png(arr, depth, ctype, (0, 1, 4, 3), palette,
                          interlace=True))
    _readers_equal(path)
    flat = _png(arr, depth, ctype, (0,), palette)
    got, want = png.decode(path.read_bytes())[0], png.decode(flat)[0]
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth", [1, 2, 4])
def test_low_depth_grayscale_png_equals_jax(tmp_path, rng, depth, interlace):
    """Grayscale below 8 bits: mode "1" (bool) at 1 bit, "L" scaled by
    Pillow's unpackers at 2 and 4, in the bands and through the decimated
    read."""
    arr = rng.integers(0, 1 << depth, (19, 23)).astype(np.uint16)
    path = tmp_path / "g.png"
    path.write_bytes(_png(arr, depth, 0, (2, 0), interlace=interlace))
    (band,) = _readers_equal(path)
    assert np.array_equal(band, (arr * (255 // ((1 << depth) - 1)))
                          .astype(np.float32) / (255 if depth == 1 else 1))
    t = traster.RasterReader(path)
    assert t._tiff._data.dtype == (bool if depth == 1 else np.uint8)


def test_pillow_bilevel_png_equals_jax(tmp_path, rng):
    path = tmp_path / "b.png"
    Image.fromarray(rng.random((17, 29)) > 0.5).save(path)
    _readers_equal(path)
    assert traster.RasterReader(path)._tiff._data.dtype == bool


BROKEN = {
    "signature only": lambda b: b[:8],
    "cut in the image data": lambda b: b[:len(b) // 2],
    "bad header crc": lambda b: b[:29] + bytes([b[29] ^ 1]) + b[30:],
    "no image data": lambda b: b[:33] + _chunk(b"IEND", b""),
}


@pytest.mark.parametrize("name", list(BROKEN))
def test_broken_png_is_refused_as_by_jax(tmp_path, rng, name):
    arr, depth, ctype, _ = _form(rng, "gray 8", (30, 40))
    path = tmp_path / "b.png"
    path.write_bytes(BROKEN[name](_png(arr, depth, ctype, (1,))))
    with pytest.raises(jraster.RasterError, match="unsupported raster"):
        jraster.RasterReader(path)
    _refused(path, "PNG")


@pytest.mark.parametrize("form", ["gray 8", "rgba 8", "palette 4"])
@pytest.mark.parametrize("interlace", [False, True])
def test_png_bit_flips_agree_with_jax(tmp_path, rng, form, interlace):
    """Pillow checks no CRC past the chunks before the image data, stops
    inflating once the image is whole (the zlib checksum unread) and reads
    the chunks after it leniently: each flipped file opens, or is refused,
    as the JAX reader opens or refuses it."""
    from test_torch_science_rasters import agree, flips

    arr, depth, ctype, palette = _form(rng, form, (9, 14))
    blob = _png(arr, depth, ctype, (4, 1), palette, interlace,
                texts=((b"tEXt", b"k\0v"),), idat_parts=2)
    for k, b in enumerate(flips(blob, rng, 40, 33)):
        path = tmp_path / f"f{k}.png"
        path.write_bytes(b)
        agree(path)


def test_png_codec_round_trip_through_pillow(rng):
    """The writer's file through Pillow and through the reader, and
    Pillow's own file through the reader."""
    u8 = rng.integers(0, 256, (50, 61)).astype(np.uint8)
    blob = png.encode_gray8(u8)
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(blob))), u8)
    assert np.array_equal(png.decode(blob)[0][..., 0], u8)
    buf = io.BytesIO()
    Image.fromarray(u8).save(buf, format="PNG", optimize=True)
    assert np.array_equal(png.decode(buf.getvalue())[0][..., 0], u8)
    with pytest.raises(ValueError):
        png.encode_gray8(np.zeros((0, 4), np.uint8))


# ---------------------------------------------------------------------------
# SafeReader, the root's reader object
# ---------------------------------------------------------------------------
import fixtures  # noqa: E402
import sarpro_tpu_torch  # noqa: E402
from sarpro_tpu.core import ops as jops  # noqa: E402
from sarpro_tpu.io import safe as jsafe  # noqa: E402
from sarpro_tpu_torch.errors import (  # noqa: E402
    SafeMissingField,
    SafeParseError,
    UnsupportedProduct,
)
from sarpro_tpu_torch.io import safe as tsafe  # noqa: E402
from test_torch_exact import native_both  # noqa: E402,F401


@pytest.fixture(scope="module")
def products(tmp_path_factory):
    root = tmp_path_factory.mktemp("safe_reader")
    return {
        "vv+vh": fixtures.make_safe(root, name="A.SAFE", seed=31),
        "hh+hv": fixtures.make_safe(root, name="B.SAFE", pols=("hh", "hv"),
                                    seed=32),
        "vv": fixtures.make_safe(root, name="C.SAFE", pols=("vv",), seed=33),
        "slc": fixtures.make_safe(root, name="D.SAFE", product_type="SLC",
                                  seed=34),
    }


READER_CASES = [("vv+vh", hint, size) for hint in
                (None, "vv", "vh", "multiband", "vv_vh_pair", "all_pairs")
                for size in (None, 32)] + [
    ("hh+hv", hint, 32) for hint in ("hh", "hv", "hh_hv_pair", "all_pairs")
] + [("vv", "all_pairs", None)]


@pytest.mark.parametrize("product,hint,size", READER_CASES)
def test_safe_reader_equals_jax(products, native_both, product, hint,
                                size):
    """Bands (f32, as the JAX reader's arrays), metadata and the operation
    accessors equal the JAX reader's, at original size and decimated on
    read."""
    safe = products[product]
    t = tsafe.SafeReader.open_with_options(safe, hint, target_size=size,
                                           device="cpu")
    j = jsafe.SafeReader.open_with_options(safe, hint, target_size=size)
    assert t.get_available_polarizations() == j.get_available_polarizations()
    assert t.metadata.polarizations == j.metadata.polarizations
    assert (t.metadata.lines, t.metadata.samples) == (j.metadata.lines,
                                                      j.metadata.samples)
    assert t.metadata.geotransform == j.metadata.geotransform
    for pol in ("vv", "vh", "hh", "hv"):
        assert getattr(t, f"has_{pol}")() == getattr(j, f"has_{pol}")()
        if getattr(j, f"has_{pol}")():
            a = getattr(t, f"{pol}_data")()
            b = np.asarray(getattr(j, f"{pol}_data")())
            assert a.dtype == torch.float32 and a.device.type == "cpu"
            assert np.array_equal(a.numpy(), b), pol
        else:
            with pytest.raises(SafeMissingField):
                getattr(t, f"{pol}_data")()
    if j.has_vv() or j.has_vh():
        assert np.array_equal(t.data().numpy(), np.asarray(j.data()))
    else:
        with pytest.raises(SafeMissingField):
            t.data()
    for name, (a, b) in {"sum": ("vv", "vh"), "ratio": ("vv", "vh"),
                         "n-diff": ("hh", "hv"),
                         "log-ratio": ("hh", "hv")}.items():
        if getattr(j, f"has_{a}")() and getattr(j, f"has_{b}")():
            got = t._op(getattr(t, f"{a}_data")(), getattr(t, f"{b}_data")(),
                        name)
            want = jops.OPERATIONS[name](getattr(j, f"{a}_data")(),
                                         getattr(j, f"{b}_data")())
            assert np.array_equal(got.numpy(), np.asarray(want)), name


def test_safe_reader_warp_matches_jax_metadata(products):
    """With a target CRS both readers warp to the same grid (the warped
    values are held to the JAX warp in tests/test_torch_warp.py)."""
    safe = products["vv+vh"]
    t = tsafe.SafeReader.open_with_options(safe, "multiband", "EPSG:4326",
                                           "bilinear", 32, device="cpu")
    j = jsafe.SafeReader.open_with_options(safe, "multiband", "EPSG:4326",
                                           "bilinear", 32)
    assert tuple(t.vh_data().shape) == np.asarray(j.vh_data()).shape
    assert (t.metadata.lines, t.metadata.samples) == (j.metadata.lines,
                                                      j.metadata.samples)
    assert t.metadata.projection == j.metadata.projection
    np.testing.assert_allclose(t.metadata.geotransform,
                               j.metadata.geotransform, rtol=1e-12)


def test_safe_reader_refusals_equal_jax(products):
    vv_only = products["vv"]
    for hint in ("vh", "multiband", "hh_hv_pair"):
        with pytest.raises(SafeMissingField):
            tsafe.SafeReader.open(vv_only, hint, device="cpu")
        with pytest.raises(jsafe.SafeMissingField):
            jsafe.SafeReader.open(vv_only, hint)
        assert tsafe.SafeReader.open_with_warnings(vv_only, hint,
                                                   device="cpu") is None
    with pytest.raises(UnsupportedProduct):
        tsafe.SafeReader.open(products["slc"], device="cpu")
    assert tsafe.SafeReader.open_with_warnings(products["slc"],
                                               device="cpu") is None
    with pytest.raises(SafeParseError, match="Unsupported polarization"):
        tsafe.SafeReader.open(vv_only, "xx", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tsafe.SafeReader.open(vv_only)


def test_safe_reader_band_stage_sees_the_first_band(products):
    staged = []
    t = tsafe.SafeReader.open_with_options(
        products["vv+vh"], "multiband", band_stage=lambda b: staged.append(
            b) or "staged", device="cpu")
    assert t.staged_band1 == "staged"
    assert len(staged) == 1 and staged[0] is t.vv_data()


def test_root_exports_equal_the_jax_roots():
    """Every name the JAX package's root resolves, the port's root resolves
    to the port's own object of the same name."""
    import sarpro_tpu

    names = ["ProcessingParams", "SarproError", "ZeroSize", "OutputFormat",
             "AutoscaleStrategy", "ProcessedImage", "BatchReport",
             "process_safe_to_path", "process_safe_to_buffer",
             "process_safe_to_buffer_with_mode", "process_directory_to_path",
             "process_safe_with_options", "iterate_safe_products",
             "save_image", "save_multiband_image", "load_polarization",
             "load_operation", "SafeReader", "SafeMetadata", "TargetCrsArg",
             "RasterReader", "RasterMetadata", "create_jpeg_metadata_sidecar",
             "embed_tiff_metadata", "extract_metadata_fields", "SafeError",
             "RasterError", "UnsupportedProduct"]
    for name in names:
        t, j = getattr(sarpro_tpu_torch, name), getattr(sarpro_tpu, name)
        assert t.__name__ == j.__name__, name
        assert t.__module__.startswith("sarpro_tpu_torch."), name
    with pytest.raises(AttributeError, match="no attribute 'nothing'"):
        sarpro_tpu_torch.nothing
