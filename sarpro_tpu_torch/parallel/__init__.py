"""Scaling past one scene on one device (port of sarpro_tpu/parallel).

`mesh`: (scene, row) meshes of torch devices. `sharded`: the fused
programs over a mesh, scenes over its scene axis and each scene's rows over
its row axis. `warp`: the warp sampler's output rows over a mesh. `batch`:
the pipelined batch driver. One process drives every device; the
reductions between row blocks are small tensors copied to the lead device.
"""
from .mesh import make_mesh  # noqa: F401
