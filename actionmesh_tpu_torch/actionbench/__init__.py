"""ActionBench evaluation on PyTorch: CD-3D, CD-4D and CD-M of predicted
mesh sequences against tracked ground-truth points (counterpart of the
top-level ``actionbench`` package, whose scipy chamfer and point-cloud
subsampling modules it shares)."""
