"""KITTI stereo driver — the `Examples/Stereo/stereo_kitti.cc` equivalent.

Usage:
  python -m plslam_tpu_torch.examples.stereo_kitti <settings.yaml>
      <sequence_dir> [out_traj.txt] [--device D]

Twin of the JAX package's `examples/stereo_kitti.py`: reads `image_0`
(left) and `image_1` (right) of a KITTI odometry sequence through the
port's loader, prints the median and mean tracking time and writes the
KITTI-format trajectory (default `CameraTrajectory.txt`).
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

    from ..datasets import kitti, tum

    slam = make_system(settings, opts.get("--device", "cuda"))
    ts, paths_l = kitti.load_index(seq_dir, "image_0")
    _, paths_r = kitti.load_index(seq_dir, "image_1")

    times = []
    for t, pl, pr in zip(ts, paths_l, paths_r):
        img_l = tum.read_gray(pl)
        img_r = tum.read_gray(pr)
        t0 = time.perf_counter()
        slam.track_stereo(img_l, img_r, float(t))
        times.append(time.perf_counter() - t0)
    slam.flush()
    slam.shutdown()

    print_times(times)
    slam.save_trajectory_kitti(out)
    print(f"trajectory saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
