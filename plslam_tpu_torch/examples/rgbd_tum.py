"""TUM RGB-D driver — the `Examples/RGB-D/rgbd_tum.cc` equivalent.

Usage:
  python -m plslam_tpu_torch.examples.rgbd_tum <settings.yaml>
      <sequence_dir> <associations.txt> [out_traj.txt] [--device D]

Twin of the JAX package's `examples/rgbd_tum.py`: each association's gray
frame and 16-bit depth map decoded by the port's loader (native, else cv2),
depth in the units of the settings' `DepthMapFactor`. Prints the median
and mean tracking time and writes the trajectory (TUM format, default
`CameraTrajectory.txt`) and `KeyFrameTrajectory.txt`.
"""
import sys
import time

import numpy as np

from . import make_system, parse_args, print_times


def main(argv=None) -> int:
    args = parse_args(argv, 3)
    if args is None:
        print(__doc__)
        return 1
    (settings, seq_dir, assoc, *rest), opts = args
    out = rest[0] if rest else "CameraTrajectory.txt"

    import cv2

    from ..datasets import tum

    slam = make_system(settings, opts.get("--device", "cuda"))
    pairs = tum.load_associations(assoc, seq_dir)
    if not pairs:
        print("No images found in association file (rgbd_tum.cc:58)")
        return 1

    times = []
    for t_rgb, p_rgb, _t_d, p_d in pairs:
        img = tum.read_gray(p_rgb)
        depth_raw = cv2.imread(p_d, cv2.IMREAD_UNCHANGED)
        if depth_raw is None:
            print(f"Failed to load depth image at: {p_d}")
            return 1
        t0 = time.perf_counter()
        slam.track_rgbd(img, depth_raw.astype(np.float32), t_rgb)
        times.append(time.perf_counter() - t0)
    slam.flush()
    slam.shutdown()

    print_times(times)
    slam.save_trajectory_tum(out)
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print(f"trajectory saved to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
