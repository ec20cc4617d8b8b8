"""vbr_tpu_torch — the voxel-based 3D reconstruction pipeline in PyTorch + CUDA.

A port of ``vbr_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The module layout mirrors ``vbr_tpu`` (``ops/``, ``pipelines/``,
``models/``, ``utils/``), so each function's counterpart sits at the same
path.  Every Pallas kernel on a ported path is a hand-written CUDA kernel
under ``csrc/``, built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda.py``); each kernel's plain PyTorch version runs for CPU
tensors only.

The package imports torch, numpy and scipy — never jax, cv2 or
``vbr_tpu``.  Entry points take ``device=`` and default to ``"cuda"``.
"""

__all__ = ["apps", "models", "ops", "pipelines", "utils"]
