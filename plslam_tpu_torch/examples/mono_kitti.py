"""KITTI odometry monocular driver — `Examples/Monocular/mono_kitti.cc`
equivalent.

Usage:
  python -m plslam_tpu_torch.examples.mono_kitti <settings.yaml>
      <sequence_dir> [out.txt] [--device D]

Twin of the JAX package's `examples/mono_kitti.py`: frames from
`image_0/` and `times.txt` through the port's prefetching loader; prints the
median tracking time and writes the KITTI-format trajectory (default
`CameraTrajectory.txt`).
"""
import sys
import time

from . import make_system, parse_args, print_times


def main(argv=None) -> int:
    args = parse_args(argv, 2)
    if args is None:
        print(__doc__)
        return 1
    (settings, seq_dir, *rest), opts = args
    out = rest[0] if rest else "CameraTrajectory.txt"

    from ..datasets import kitti

    slam = make_system(settings, opts.get("--device", "cuda"))
    times = []
    for ts, img in kitti.frames(seq_dir):
        t0 = time.perf_counter()
        slam.track_monocular(img, ts)
        times.append(time.perf_counter() - t0)
    slam.flush()
    slam.shutdown()
    print_times(times, mean=False)
    slam.save_trajectory_kitti(out)
    print(f"trajectory saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
