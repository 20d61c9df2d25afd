"""The port runs without jax, Pillow or cv2 (the machine with the GPU has
none of them) and without the JAX package: it imports nothing of
sarpro_tpu, whose host modules it keeps its own copies of."""
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "sarpro_tpu_torch"


def test_port_sources_import_no_jax_pillow_or_cv2():
    """No jax, Pillow, cv2 or ml_dtypes, and nothing of the JAX package
    (`sarpro_tpu` and `sarpro_tpu.*`; `sarpro_tpu_torch` is the port)."""
    pattern = re.compile(
        r"^\s*(import|from)\s+((jax|jaxlib|PIL|cv2|ml_dtypes)\b"
        r"|sarpro_tpu(\.|\s|$))", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PORT.rglob("*.py")
                 if pattern.search(p.read_text())]
    offenders += [m for m in ("chip_smoke.py", "kernel_ab.py")
                  if pattern.search((REPO / m).read_text())]
    assert offenders == []
    # the multi-device modules and the raster decoders are among the files
    # scanned
    assert {"mesh.py", "sharded.py", "warp.py", "batch.py"} <= {
        p.name for p in (PORT / "parallel").glob("*.py")}
    assert {"pilraster.py", "pixels.py", "png.py", "jpeg.py", "bmp.py",
            "gif.py", "netpbm.py", "jpeg2000.py", "webp.py", "rawmode.py",
            "fits.py", "mcidas.py", "spider.py", "im.py", "sgi.py", "tga.py",
            "pcx.py", "sun.py", "psd.py", "qoi.py", "ico.py", "icns.py",
            "bcn.py", "dds.py", "ftex.py", "blp.py", "xbm.py", "xpm.py",
            "msp.py", "pixar.py", "gbr.py", "fli.py", "pcd.py", "xvthumb.py",
            "imt.py", "iptc.py", "avif.py"} <= {
                p.name for p in (PORT / "io").glob("*.py")}
    for line in ("import sarpro_tpu", "from sarpro_tpu.io import safe",
                 "  from sarpro_tpu import _native", "import jax.numpy"):
        assert pattern.search(line), line
    assert not pattern.search("from sarpro_tpu_torch.io import safe")


def test_cpu_slice_runs_with_jax_and_pillow_blocked(tmp_path):
    script = textwrap.dedent("""
        import pkgutil, sys
        for name in ("jax", "jaxlib", "PIL", "cv2", "ml_dtypes",
                     "sarpro_tpu"):
            sys.modules[name] = None  # any import of them now fails
        sys.path[:0] = [sys.argv[1]]
        from pathlib import Path
        import sarpro_tpu_torch
        for m in pkgutil.walk_packages(sarpro_tpu_torch.__path__,
                                       "sarpro_tpu_torch."):
            __import__(m.name)
        import chip_smoke
        from sarpro_tpu_torch import cli
        from sarpro_tpu_torch.io.tiffio import TiffReader
        from sarpro_tpu_torch.io.writers import jpeg

        got = []
        jpeg.write_synrgb_jpeg_dct = lambda o, c, r, co: got.append(co.shape)
        # the port's own copy of tests/fixtures.make_safe
        safe = chip_smoke.make_safe(Path(sys.argv[2]), shape=(200, 300))
        rc = cli.run(["-i", str(safe), "-o", sys.argv[2] + "/o.jpg", "-f",
                      "jpeg", "--polarization", "multiband", "--autoscale",
                      "tamed", "--size", "64", "--pad", "--fast"],
                     device="cpu")
        assert rc == 0 and got == [(3, 8, 8, 8, 8)], (rc, got)
        rc = cli.run(["-i", str(safe), "-o", sys.argv[2] + "/w.jpg", "-f",
                      "jpeg", "--polarization", "multiband", "--autoscale",
                      "clahe", "--size", "64", "--pad", "--target-crs",
                      "auto", "--resample-alg", "cubic", "--fast"],
                     device="cpu")
        assert rc == 0 and got[1:] == [(3, 8, 8, 8, 8)], (rc, got)
        prj = Path(sys.argv[2] + "/w.prj").read_text()
        assert "UTM zone 32N" in prj, prj
        jpeg.write_gray_jpeg_dct = lambda o, c, r, co: got.append(co.shape)
        for pol, fmt, extra in (("vv", "tiff", ["--bit-depth", "u16"]),
                                ("multiband", "tiff", []),
                                ("ratio", "jpeg", [])):
            out = sys.argv[2] + f"/{pol}.{fmt}"
            rc = cli.run(["-i", str(safe), "-o", out, "-f", fmt,
                          "--polarization", pol, "--autoscale", "robust",
                          "--size", "64", "--fast"] + extra, device="cpu")
            assert rc == 0, (pol, rc)
        assert TiffReader(sys.argv[2] + "/vv.tiff").read(1).dtype == "uint16"
        assert TiffReader(sys.argv[2] + "/multiband.tiff").samples == 2
        assert got[2:] == [(6, 8, 8, 8)], got
        # exact mode (no --fast): the gray and the synRGB pixel JPEGs, coded
        # by the native library the port builds, through no other encoder
        from sarpro_tpu_torch import _native
        for pol, strategy in (("vh", "standard"), ("multiband", "clahe")):
            out = sys.argv[2] + f"/exact_{pol}.jpg"
            argv = ["-i", str(safe), "-o", out, "-f", "jpeg",
                    "--polarization", pol, "--autoscale", strategy,
                    "--size", "64", "--pad"]
            if _native.available():
                assert cli.run(argv, device="cpu") == 0, pol
                blob = Path(out).read_bytes()
                assert blob[:2] == b"\\xff\\xd8" and blob[-2:] == b"\\xff\\xd9"
            else:
                try:
                    cli.run(argv, device="cpu")
                    raise AssertionError("a JPEG without the native coder")
                except RuntimeError as e:
                    assert "native JPEG encoder" in str(e), e
        assert len(got) == 3, got  # the exact routes coded no DCT blocks
        # the streamed path (core/streamed), with the big-scene limit below
        # this product: exact mode's defaults at original size, a synRGB JPEG
        from sarpro_tpu_torch.core import streamed
        big_scene = streamed.BIG_SCENE_PIXELS
        streamed.BIG_SCENE_PIXELS = 1000
        rc = cli.run(["-i", str(safe), "-o", sys.argv[2] + "/big.tiff"],
                     device="cpu")
        assert rc == 0, rc
        assert TiffReader(sys.argv[2] + "/big.tiff").read(1).shape == (200, 300)
        rc = cli.run(["-i", str(safe), "-o", sys.argv[2] + "/big.jpg", "-f",
                      "jpeg", "--polarization", "multiband", "--fast"],
                     device="cpu")
        assert rc == 0 and got[3:] == [(3, 25, 38, 8, 8)], (rc, got)
        streamed.BIG_SCENE_PIXELS = big_scene
        # the sharded routes on an 8-entry CPU mesh: the rows of the device
        # programs and of the warp's output split over the mesh
        from sarpro_tpu_torch.parallel import mesh
        mesh.HOST_DEVICE_COUNT = 8
        for name, extra in (("shd.tiff", []),
                            ("shdw.tiff", ["--target-crs", "auto"])):
            rc = cli.run(["-i", str(safe), "-o", sys.argv[2] + "/" + name,
                          "--shard-devices", "8", "--size", "64"] + extra,
                         device="cpu")
            assert rc == 0, (name, rc)
        mesh.HOST_DEVICE_COUNT = 1
        # the GUI: a single-file TIFF job on a worker thread, and the preview
        # PNG the port's own writer encodes
        import json, threading, time, urllib.request
        from sarpro_tpu_torch.gui.server import make_server
        from sarpro_tpu_torch.io import png
        srv = make_server("127.0.0.1", 0, device="cpu")
        threading.Thread(target=srv.serve_forever, args=(0.05,),
                         daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def call(path, body=None):
            req = urllib.request.Request(
                base + path, method="GET" if body is None else "POST",
                data=None if body is None else json.dumps(body).encode())
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.headers["Content-Type"], r.read()

        call("/api/state", {"mode": "single", "input_path": str(safe),
                            "output_path": sys.argv[2] + "/gui.tiff",
                            "params": {"autoscale": "standard",
                                       "size": 64, "bit_depth": "U16"}})
        assert json.loads(call("/api/process", {})[1])["started"]
        for _ in range(600):
            state = json.loads(call("/api/state")[1])
            if not state["running"] and state["last_result"]:
                break
            time.sleep(0.05)
        assert state["last_result"]["ok"], state
        ctype, blob = call("/api/preview")
        assert ctype == "image/png", ctype
        img, _ = png.decode(blob)
        assert img.shape == (43, 64, 1), img.shape
        srv.shutdown()
        srv.server_close()
        # the raster decoders: a JPEG from the port's own coder, a BMP, a
        # GIF and a PGM written here, a JP2 and a WebP, opened through
        # RasterReader
        import struct
        import numpy as np
        from sarpro_tpu_torch.io.raster import RasterReader
        d = Path(sys.argv[2])
        g = (np.arange(40 * 56).reshape(40, 56) * 7 % 251).astype(np.uint8)
        want = {}
        if _native.available():
            (d / "r.jpg").write_bytes(_native.jpeg_encode_gray(g))
            want["r.jpg"] = (g, 1)
        head = struct.pack("<IiiHHIIiiII", 40, 56, -40, 1, 24, 0, 0, 0, 0,
                           0, 0)
        (d / "r.bmp").write_bytes(b"BM" + struct.pack("<IHHI", 0, 0, 0, 54)
                                  + head + np.repeat(g, 3, axis=1).tobytes())
        want["r.bmp"] = (g, 0)
        # GIF: 8-bit literal codes, 9 bits each, a clear code every 200
        codes = []
        for i, v in enumerate(g.reshape(-1)):
            if i % 200 == 0:
                codes.append(256)
            codes.append(int(v))
        codes.append(257)
        acc = sum(c << (9 * i) for i, c in enumerate(codes))
        lzw = acc.to_bytes((9 * len(codes) + 7) // 8, "little")
        blocks = b"".join(bytes([len(lzw[i:i + 255])]) + lzw[i:i + 255]
                          for i in range(0, len(lzw), 255))
        pal = bytes(v for i in range(256) for v in (i, 255 - i, i // 2))
        (d / "r.gif").write_bytes(
            b"GIF89a" + struct.pack("<HHBBB", 56, 40, 0xF7, 0, 0) + pal
            + b"\\x2c" + struct.pack("<HHHHB", 0, 0, 56, 40, 0) + b"\\x08"
            + blocks + b"\\x00\\x3b")
        want["r.gif"] = (np.frombuffer(pal, np.uint8).reshape(256, 3)[g], 0)
        (d / "r.pgm").write_bytes(b"P5\\n56 40\\n255\\n" + g.tobytes())
        want["r.pgm"] = (g, 0)
        # JPEG 2000: the committed u16 codestream, in a JP2 box, decodes to
        # the DN chip_smoke seeds it from
        code = (chip_smoke.J2K_DIR / chip_smoke.J2K_BAND).read_bytes()
        (d / "r.jp2").write_bytes(chip_smoke.jp2_wrap(code, 512, 512, 1, 16,
                                                      17))
        tile = chip_smoke.j2k_band_tile()
        data = RasterReader(d / "r.jp2")._tiff._data
        assert data.dtype == np.uint16 and np.array_equal(data[..., 0],
                                                          tile)
        # WebP: a committed lossy RGBA with its VP8L-coded ALPH plane
        # decodes to the SHA-256 of Pillow's decode
        import hashlib
        name = "rgba_lossy_alph.webp"
        data = RasterReader(chip_smoke.WEBP_DIR / name)._tiff._data
        assert data.shape == (160, 176, 4), data.shape
        assert hashlib.sha256(data.tobytes()).hexdigest() == \
            chip_smoke.WEBP_FIXTURES[name]
        # the float, scientific and run-length formats: the files of
        # tests/data/formats decode to the SHA-256 of Pillow's decode, and
        # chip_smoke's PFM, FITS, McIdas, SGI RLE and TGA RLE writers' bands
        # read back as Pillow reads them
        for name, digest in chip_smoke.FORMATS_FIXTURES.items():
            data = RasterReader(chip_smoke.FORMATS_DIR / name)._tiff._data
            assert hashlib.sha256(data.tobytes()).hexdigest() == digest, name
        dn = chip_smoke.formats_dn(chip_smoke.FORMATS_SEED, 30, 41)
        u8 = chip_smoke.formats_u8(dn)
        i16 = np.minimum(dn, 32767).astype(np.int16)
        for name, blob, ref in (
                ("b.pfm", chip_smoke.pfm_write(dn.astype(np.float32)),
                 dn.astype(np.float32)),
                ("b.fits", chip_smoke.fits_write(i16, 16),
                 i16.astype(">i2").view("<u2")[::-1]),
                ("b.area", chip_smoke.mcidas_write(dn), dn),
                ("b.sgi", chip_smoke.sgi_rle_write(u8), u8),
                ("b.tga", chip_smoke.tga_rle_write(u8), u8)):
            (d / name).write_bytes(blob)
            data = RasterReader(d / name)._tiff._data[..., 0]
            assert data.dtype == ref.dtype and np.array_equal(data, ref), \
                name
        # Pillow's long tail: the files chip_smoke.LONGTAIL_FIXTURES names
        # decode to the SHA-256 of Pillow's decode, and the BC4 / BC7 / IMT
        # writers' bands read back (BC4 and BC7 within their block ramps)
        for name, digest in chip_smoke.LONGTAIL_FIXTURES.items():
            data = RasterReader(chip_smoke.FORMATS_DIR / name)._tiff._data
            assert chip_smoke.decode_digest(data) == digest, name
        for label, name, writer in chip_smoke._longtail_bands(64):
            (d / name).write_bytes(writer())
            data = RasterReader(d / name)._tiff._data[..., 0]
            ref = chip_smoke.formats_u8(chip_smoke.formats_dn(
                chip_smoke.FORMATS_SEED + 3, 64, 64))
            err = np.abs(data.astype(int) - ref).max()
            assert err <= (0 if label == "IMT L" else 18), (label, err)
        # AVIF: the files chip_smoke.AVIF_FIXTURES names decode to the
        # SHA-256 of Pillow's decode
        for name, digest in chip_smoke.AVIF_FIXTURES.items():
            data = RasterReader(chip_smoke.AVIF_DIR / name)._tiff._data
            assert chip_smoke.decode_digest(data) == digest, name
        for name, (ref, tol) in want.items():
            data = RasterReader(d / name)._tiff._data
            ref = ref if ref.ndim == 3 else ref[..., None]
            err = np.abs(data[..., :ref.shape[2]].astype(int) - ref).max()
            assert data.shape[:2] == (40, 56) and err <= tol, (name, err)
        assert not [m for m in sys.modules if m.startswith("sarpro_tpu.")]
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script, str(REPO),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
