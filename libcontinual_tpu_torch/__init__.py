"""libcontinual_tpu_torch: the PyTorch and CUDA port of libcontinual_tpu.

It mirrors the JAX package's module layout and names, runs on one NVIDIA GPU
(Hopper, sm_90a) with hand-written CUDA kernels where the JAX package has
Pallas kernels, and imports nothing of JAX or of ``libcontinual_tpu``. The
ported slice is the L2P training path on a ViT; run it with
``python -m libcontinual_tpu_torch --config <name>``.
"""

__version__ = "0.1.0"
