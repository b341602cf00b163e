"""aten_tpu_torch: the PyTorch/CUDA port of the aten_tpu path tracer.

Each module is the counterpart of the `aten_tpu` module with the same
path; `aten_tpu` stays the reference the port is tested against.  The
port imports neither `jax` nor `aten_tpu`.

Tensors live on one explicit device, chosen when a scene is built
(`device.resolve_device`); there is no global default device.  The
hand-written kernels (the traversal kernels K1, K3, K4 and K5, and the
microbenchmarks of `tools/`) are CUDA C++ under `kernels/`, built at
first use (`ops/traverse_cuda.py`, `tools/lab_library.py`).
"""
