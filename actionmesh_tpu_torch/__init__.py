"""actionmesh_tpu_torch: the video-to-4D pipeline in PyTorch for NVIDIA Hopper.

A port of ``actionmesh_tpu`` (JAX + Pallas). Module paths and function
names mirror the JAX package; the Pallas kernels on the main path are
replaced by hand-written Hopper kernels (``csrc/flash_fwd.cu`` for flash
attention, a Triton kernel in ``ops/rope_norm.py`` for the fused qk
rms-norm + RoPE). On CPU tensors every kernel wrapper runs its plain
PyTorch version instead, so the package imports and is tested without a GPU.
"""
