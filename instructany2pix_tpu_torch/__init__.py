"""PyTorch/CUDA port of instructany2pix_tpu for NVIDIA Hopper GPUs.

Mirrors the JAX package's layout (`core/`, `ops/`, `models/`,
`diffusion/`, `llm/`, `codecs/`, `pipeline.py`) and imports neither JAX
nor the JAX package. Hand-written CUDA kernels live in `csrc/` and are
built at first use (`ops/_build.py`).
"""
