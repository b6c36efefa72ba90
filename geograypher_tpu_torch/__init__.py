"""geograypher_tpu_torch: the PyTorch + CUDA port of geograypher_tpu.

Same sub-package layout as the JAX package, which stays the reference:

  kernels/     nvcc build + ctypes loading of the hand-written CUDA kernels
  csrc/        the CUDA C++ kernel sources (sm_90a)
  ops/         triangle setup, tile binning, the raster and counts kernels'
               wrappers with their plain PyTorch versions, aggregation
  cameras/     camera batches on a torch device, Metashape parsing,
               segmentor-wrapped camera sets
  meshes/      TexturedMesh: the per-view aggregation loop
  entrypoints/ user-facing workflows (aggregate_images)
  utils/       host-side scene fixtures and the spatial face order
  interop.py   carries mesh, camera and raster-config state over from
               the JAX package

Importing the package builds nothing and imports no JAX; the main path
(in-memory mesh, cameras, segmentor set, streaming aggregation) needs
nothing of the JAX package.
"""

__version__ = "0.1.0"
