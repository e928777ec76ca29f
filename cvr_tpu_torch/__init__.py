"""cvr_tpu_torch: the PyTorch/CUDA port of cvr_tpu for NVIDIA Hopper.

The routed-gather SpMV main path runs here on an H100: the jax-free host
layer (MatrixMarket/synthetic ingest, CSR, the SELL and SELL-R packs over
the shared native library) feeds four CUDA kernels written for sm_90a
(cvr_tpu_torch/csrc/route_kernels.cu).  The JAX package ``cvr_tpu`` is the
reference each part is tested against; nothing here imports it or jax.
"""

__version__ = "0.1.0"
