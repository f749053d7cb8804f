"""PyTorch / CUDA port of plslam_tpu (point-and-line visual SLAM).

The package mirrors the subpackage layout of `plslam_tpu` and keeps its
module and function names. It imports torch and numpy only; the JAX package
stays the reference that every ported function is tested against.

The port currently covers the per-frame monocular tracking step (point
extraction -> undistortion -> local-map tracking) plus the depth bootstrap
that gives it a map. The projection-gated Hamming top-2 search runs as a
hand-written CUDA kernel on CUDA tensors (`ops/gated_match.py`).
"""
