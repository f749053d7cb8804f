"""EuRoC monocular driver — `Examples/Monocular/mono_euroc.cc` equivalent.

Usage:
  python -m plslam_tpu_torch.examples.mono_euroc <settings.yaml>
      <cam0_data_dir> <timestamps.txt> [out.txt] [--device D]

Twin of the JAX package's `examples/mono_euroc.py`: frames named by their
nanosecond timestamps through the port's prefetching loader; prints the
median tracking time and writes the keyframe trajectory in TUM format
(default `CameraTrajectory.txt`).
"""
import sys
import time

from . import make_system, parse_args, print_times


def main(argv=None) -> int:
    args = parse_args(argv, 3)
    if args is None:
        print(__doc__)
        return 1
    (settings, img_dir, ts_file, *rest), opts = args
    out = rest[0] if rest else "CameraTrajectory.txt"

    from ..datasets import euroc

    slam = make_system(settings, opts.get("--device", "cuda"))
    times = []
    for ts, img in euroc.frames(img_dir, ts_file):
        t0 = time.perf_counter()
        slam.track_monocular(img, ts)
        times.append(time.perf_counter() - t0)
    slam.flush()
    slam.shutdown()
    print_times(times, mean=False)
    slam.save_keyframe_trajectory_tum(out)
    print(f"trajectory saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
