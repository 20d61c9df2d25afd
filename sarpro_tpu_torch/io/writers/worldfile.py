"""World file / .prj sidecar writers (reference: src/io/writers/worldfile.rs:7-64)."""
# A copy of sarpro_tpu/io/writers/worldfile.py, so that the port imports
# nothing of the JAX package; tests/test_torch_host_copies.py holds the two
# equal.
from __future__ import annotations

from pathlib import Path


def write_world_file(output_image, geotransform) -> None:
    """Write a world file in pixel-center convention, 12-decimal precision.

    Extension mapping (reference: worldfile.rs:17-30): jpg/jpeg→jgw, png→pgw,
    tif/tiff→tfw, other→first letter + 'w', none→wld.
    """
    output_image = Path(output_image)
    ext = output_image.suffix.lstrip(".").lower()
    if ext in ("jpg", "jpeg"):
        world_ext = "jgw"
    elif ext == "png":
        world_ext = "pgw"
    elif ext in ("tif", "tiff"):
        world_ext = "tfw"
    elif ext:
        world_ext = ext[0] + "w"
    else:
        world_ext = "wld"
    world_path = output_image.with_suffix("." + world_ext)

    gt = list(geotransform)
    a, d, b, e = gt[1], gt[4], gt[2], gt[5]
    # C, F: center of upper-left pixel (reference: worldfile.rs:34-42)
    c = gt[0] + 0.5 * a + 0.5 * b
    f = gt[3] + 0.5 * d + 0.5 * e
    with open(world_path, "w") as fh:
        for v in (a, d, b, e, c, f):
            fh.write(f"{v:.12f}\n")


def write_prj_file(output_image, projection: str) -> None:
    """reference: worldfile.rs:57-64."""
    Path(output_image).with_suffix(".prj").write_bytes(projection.encode())
