#!/usr/bin/env python3
"""Where one `stereo.stereo_match` call spends its time on the card, at the
`SLAMConfig` defaults (1024 features, 8 levels) on frame 3 of
`chip_smoke.py`'s stereo sequence:

- host ms of one call and of ten calls queued behind a 300 ms spin kernel,
  for the whole search and for its pieces (a host that blocks behind the
  spin shows up as ten calls taking ~300 ms);
- the CUDA runtime calls of one search (torch.profiler), which count its
  kernel launches;
- device ms per call from `chip_smoke.cuda_ms`, with one and two calls per
  timed batch.

    python3 scripts/stereo_probe.py

Needs a CUDA device; takes well under a minute on an H100.
"""
from __future__ import annotations

import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from plslam_tpu_torch.ops import extract, hamming, stereo
    from torch.profiler import ProfilerActivity, profile
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(f"card: {cs.card_line()}, torch {torch.__version__}")
    _, frames, _ = cs.render_stereo_sequence()
    cfg = extract.ExtractorConfig()
    ext = extract.PointExtractor(cfg, cs.HEIGHT, cs.WIDTH).to(dev)
    sf, _ = extract.scale_factors(cfg, dev)
    il, ir = (torch.from_numpy(np.asarray(f).astype(np.uint8)).to(dev).float()
              for f in frames[cs.STEREO_DEPTH_FRAME])
    fl, fr = ext(il), ext(ir)
    match = partial(stereo.stereo_match, fx=cs.FX,
                    baseline=cs.STEREO_BASELINE, scale_factors=sf)
    pieces = {
        "stereo_match": lambda: match(fl, fr, il, ir),
        "distance_matrix": lambda: hamming.distance_matrix(fl.desc, fr.desc),
        "masked_best2": lambda: hamming.masked_best2(
            hamming.distance_matrix(fl.desc, fr.desc),
            torch.ones(fl.desc.shape[0], fr.desc.shape[0], dtype=torch.bool,
                       device=dev)),
        "gather_patches": lambda: stereo._gather_patches(ir, fl.uv, 5),
    }
    cycles_per_ms = cs._sleep_cycles_per_ms()
    for name, fn in pieces.items():
        fn()
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(int(cycles_per_ms * 300))
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        for _ in range(9):
            fn()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
        print(f"{name}: host ms behind a 300 ms spin: one call "
              f"{1e3 * (t1 - t0):.2f}, ten calls {1e3 * (t2 - t0):.2f}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        match(fl, fr, il, ir)
    calls = {}
    for e in prof.events():
        if e.name.startswith("cuda"):
            calls[e.name] = calls.get(e.name, 0) + 1
    print(f"CUDA runtime calls in one stereo_match: {calls}")
    for batch in (1, 2):
        print(f"stereo_match device ms per call, {batch} per batch: "
              f"{cs.cuda_ms(lambda: match(fl, fr, il, ir), batch=batch):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
