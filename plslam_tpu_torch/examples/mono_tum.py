"""TUM monocular driver — the `Examples/Monocular/mono_tum.cc` equivalent.

Usage:
  python -m plslam_tpu_torch.examples.mono_tum <settings.yaml> <sequence_dir>
      [out_traj.txt] [--chunked B] [--device D] [--trace PATH]

Twin of the JAX package's `examples/mono_tum.py`. Frames are decoded by the
port's prefetching loader (`utils/native_loader.py`: native C++ threads, or
cv2) and the next frame is copied to the device from pinned host memory
without waiting (`non_blocking=True`) before the current frame is tracked,
so decode and upload overlap tracking. `--chunked B` stacks B frames on the
device per `System.track_chunked` call, two chunks staged ahead (keyframe
decisions one chunk late). It prints the median and mean tracking time and
the end-to-end rate, and writes the trajectory (TUM format, default
`CameraTrajectory.txt`), `KeyFrameTrajectory.txt` and `mono_tum_stats.json`
into the working directory. `--trace PATH` turns the System's host spans on
and writes its tracer's logs to PATH as a Chrome trace (Perfetto reads it):
the host spans and the device spans on one timeline, the keyframe chain,
loop closing and global-BA rounds among them (the rings keep the last
65,536 records and spans).
"""
import json
import sys
import time

import numpy as np
import torch

from . import make_system, parse_args, print_times


def _upload(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """A uint8 host array on `device`: through pinned memory, not waiting,
    on CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(host, np.uint8))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def main(argv=None) -> int:
    args = parse_args(argv, 2, ("--chunked", "--device", "--trace"))
    if args is None:
        print(__doc__)
        return 1
    (settings, seq_dir, *rest), opts = args
    out = rest[0] if rest else "CameraTrajectory.txt"
    chunk = int(opts.get("--chunked", 0))

    from ..datasets import tum
    from ..utils.native_loader import PrefetchLoader

    slam = make_system(settings, opts.get("--device", "cuda"))
    device = slam.device
    if "--trace" in opts:
        slam.tracer.enable()
    tss, paths = tum.load_rgb_index(seq_dir)
    loader = PrefetchLoader(paths, queue_depth=8, n_threads=2)
    t_all0 = time.perf_counter()
    times = []
    if chunk > 0:
        depth = 2      # chunks staged ahead of the one being tracked
        frames_np = list(loader)
        n = len(frames_np) - len(frames_np) % chunk
        host_chunks = [np.stack(frames_np[c:c + chunk])
                       for c in range(0, n, chunk)]
        ts_chunks = [[float(tss[c + j]) for j in range(chunk)]
                     for c in range(0, n, chunk)]
        staged = [_upload(hc, device) for hc in host_chunks[:depth]]
        for ci in range(len(host_chunks)):
            if ci + depth < len(host_chunks):
                staged.append(_upload(host_chunks[ci + depth], device))
            t0 = time.perf_counter()
            slam.track_chunked(staged.pop(0), ts_chunks[ci])
            times.append((time.perf_counter() - t0) / chunk)
        for j in range(n, len(frames_np)):      # the tail, frame by frame
            slam.track_monocular(frames_np[j], float(tss[j]))
    else:
        pending = None      # (timestamp, frame on the device)
        for i, img in enumerate(loader):
            dev = _upload(img, device)
            if pending is not None:
                t0 = time.perf_counter()
                slam.track_monocular(pending[1], pending[0])
                times.append(time.perf_counter() - t0)
            pending = (float(tss[i]), dev)
        if pending is not None:
            t0 = time.perf_counter()
            slam.track_monocular(pending[1], pending[0])
            times.append(time.perf_counter() - t0)
    slam.flush()
    slam.shutdown()
    wall = time.perf_counter() - t_all0
    loader.close()

    print_times(times)
    print(f"end-to-end (decode+upload+track): "
          f"{len(paths) / wall:.1f} fps over {len(paths)} frames")
    slam.save_trajectory_tum(out)
    slam.save_keyframe_trajectory_tum("KeyFrameTrajectory.txt")
    print(f"trajectory saved to {out}")
    if "--trace" in opts:
        n = slam.tracer.export(opts["--trace"])
        print(f"trace of {n} events saved to {opts['--trace']}")
    times = sorted(times)
    with open("mono_tum_stats.json", "w") as f:
        json.dump({
            "median_track_s": times[len(times) // 2],
            "mean_track_s": float(np.mean(times)),
            "n_kf": int(slam.n_kf_host),
            "n_loops": int(getattr(slam.loop_closer, "n_loops", 0)),
            "n_gba_done": int(getattr(slam, "n_gba_done", 0)),
            # beyond the JAX driver's keys: the run's counts for harnesses
            "frames": len(paths),
            "tracked_frames": len(slam.stats),
            "lost_after_init": sum(1 for s in slam.stats if s.get("lost")),
            "map_points": slam.n_map_points(),
            "end_to_end_fps": len(paths) / wall,
            "native_loader": loader.native,
        }, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
