"""The benchmark's plain reference: extraction, line detection and tracking
against the local map, frozen copies in plain PyTorch of the port's code as
it stood when the benchmark was written. Nothing here imports the port
(`plslam_tpu_torch`) or the JAX package, so later changes to the program
cannot move what its outputs are judged against."""
