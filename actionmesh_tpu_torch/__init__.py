"""actionmesh_tpu_torch: the video-to-4D pipeline in PyTorch for NVIDIA Hopper.

A port of ``actionmesh_tpu`` (JAX + Pallas). Module paths and function
names mirror the JAX package; the Pallas kernels on the main path are
replaced by hand-written Hopper kernels in CUDA C++ under ``csrc/``
(``flash_fwd.cu`` and ``flash_bwd.cu`` for flash attention,
``rms_rope.cu`` for the fused qk rms-norm + RoPE and its backward,
``nn_argmin.cu`` for the nearest-neighbour search). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead, so the package imports and is tested without a GPU.
"""
