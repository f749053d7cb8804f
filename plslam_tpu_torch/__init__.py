"""PyTorch / CUDA port of plslam_tpu (point-and-line visual SLAM).

The package mirrors the subpackage layout of `plslam_tpu` and keeps its
module and function names. It imports torch and numpy only; the JAX package
stays the reference that every ported function is tested against.

The port covers the point-and-line `models/system.System` for the three
sensors with its dispatch paths, the multi-stream trackers
(`parallel/multistream.py`) and map I/O. The projection-gated Hamming top-2
search runs as a hand-written CUDA kernel on CUDA tensors
(`ops/gated_match.py`), batched over streams under `torch.func.vmap`.
"""
