"""cvr_tpu_torch: the PyTorch/CUDA port of cvr_tpu for NVIDIA Hopper.

The SpMV and SpMM paths run here on an H100: the jax-free host layer
(MatrixMarket/synthetic ingest, CSR and the packed formats over the
shared native library) feeds CUDA kernels written for sm_90a
(cvr_tpu_torch/csrc/).  The JAX package ``cvr_tpu`` is the
reference each part is tested against; nothing here imports it or jax.
"""

__version__ = "0.1.0"
