"""Scaling past one scene at a time (port of sarpro_tpu/parallel).

`batch`: the pipelined batch driver on one GPU. Meshes, row sharding and
the multi-GPU paths are not ported yet (ROADMAP queue 1 #7).
"""
