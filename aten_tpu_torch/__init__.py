"""aten_tpu_torch: the PyTorch/CUDA port of the aten_tpu path tracer.

Each module is the counterpart of the `aten_tpu` module with the same
path; `aten_tpu` stays the reference the port is tested against.  The
port imports neither `jax` nor `aten_tpu`.

Tensors live on one explicit device, chosen when a scene is built
(`device.resolve_device`); there is no global default device.  The one
hand-written kernel, the threaded-BVH traversal, is CUDA C++ under
`kernels/`, built at first use (`ops/traverse_cuda.py`).
"""
