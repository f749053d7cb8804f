"""CPU tests of the benchmark's harness (and two card tests that skip
without a card). Run: `python -m pytest benchmark/tests -q`; on the card,
`python -m pytest benchmark/tests -q -m cuda`."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
FORBIDDEN = {"jax", "jaxlib", "flax", "plslam_tpu"}
CELL = BENCH["workloads"][0]["name"]

# a small deployment for the CPU: the TUM1 camera at half size, fewer
# features and levels, small map capacities
SMALL = dict(width=320, height=240, fx=517.306408 / 2, fy=516.469215 / 2,
             cx=318.643040 / 2, cy=255.313989 / 2, n_features=512,
             n_levels=4, max_kf=24, max_pt=4096, max_ln=512, n_lf=128)


def _imports(path: Path) -> set:
    """Top-level names of the absolute imports of a Python file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_every_named_file_loads():
    """Each cell's configuration and mix, and each per-layer metric's
    reader, load by name, and each reader declares what BENCHMARK.json
    says of its metric; every configuration, mix and reader in the folder
    loads too."""
    from benchmark import run
    from benchmark.harness import config, traffic
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        c = config.load(w["config"])
        assert c["name"] == w["config"] and w["config"] in configs
        assert (ROOT / configs[w["config"]]["file"]).exists()
        assert (BENCH_DIR / "limits" / f"{w['name']}.json").exists()
        assert traffic.load(w["traffic"])["name"] == w["traffic"]
    for path in (BENCH_DIR / "configs").glob("*.json"):
        c = config.load(path.stem)
        assert (BENCH_DIR / "entries" / f"{c['entry']}.py").exists()
        fields = config.slam_fields(c)
        assert fields["n_features"] == 1024 and fields["k1"] != 0.0
    for path in (BENCH_DIR / "traffic").glob("*.json"):
        m = traffic.load(path.stem)
        v, w_deg = traffic.Path6(m["path"]).mean_rates()
        assert abs(v - m["path"]["speed_m_s"]) < 1e-9
        assert abs(w_deg - m["path"]["rot_deg_s"]) < 1e-9
    for m in BENCH["per_layer"]:
        r = run.load_reader(m["name"])
        assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        assert callable(r.read)
    for path in (BENCH_DIR / "metrics").glob("*.py"):
        r = run.load_reader(path.stem)
        assert r.UNIT and r.SOURCE and r.MOVES and callable(r.read)


def test_renderer_is_fixed_by_the_seed():
    from benchmark.harness import config, traffic
    cam = config.camera(dict(config.slam_fields(config.load("tum1_mono")),
                             **SMALL))
    mix = traffic.load("revisit")
    a = traffic.Stream(mix, cam, 2 ** 33 + 5, "cpu").frames(3, 2)
    b = traffic.Stream(mix, cam, 2 ** 33 + 5, "cpu").frames(3, 2)
    c = traffic.Stream(mix, cam, 2 ** 33 + 6, "cpu").frames(3, 2)
    assert a.dtype == torch.uint8 and a.shape == (2, 240, 320)
    assert torch.equal(a, b)
    assert (a != c).float().mean() > 0.5
    assert not torch.equal(a[0], a[1])


def test_k1_bound_arithmetic():
    """At 1024 queries x 12288 map points, every point visible, gated:
    3,646,464 bytes, 1.09 us over 3.35 TB/s (PERF.md); an invisible point
    costs its flag only, and with the gates off no position, radius or
    level is read."""
    from benchmark.harness import k1
    n, p = 1024, 12288
    args = (torch.zeros(n, 256, dtype=torch.uint8), torch.zeros(n, 2),
            torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.bool),
            torch.zeros(p, 256, dtype=torch.uint8), torch.zeros(p, 2),
            torch.zeros(p), torch.zeros(p, dtype=torch.int32),
            torch.ones(p, dtype=torch.bool))
    nbytes, pairs = k1.launch_work(args, True)
    assert nbytes == 3_646_464 and pairs == 0
    assert abs(k1.bound_s(nbytes, pairs) - 1.0885e-6) < 1e-9
    assert k1.launch_work(args, False)[0] == 3_646_464 - p * 16
    hidden = args[:8] + (torch.zeros(p, dtype=torch.bool),)
    assert k1.launch_work(hidden, True)[0] == 3_646_464 - p * (256 + 16)
    # every pair passing: 2 x 256 x 1024 x 12288 operations over 1979 TOP/s
    assert abs(k1.bound_s(0, n * p) - 2 * 256 * n * p / 1979e12) < 1e-15


def test_no_module_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        assert not (_imports(path) & FORBIDDEN), path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        names = _imports(path)
        assert "plslam_tpu_torch" not in names and not names & FORBIDDEN, path
        assert "benchmark" not in names, path   # only relative imports


def _small_run(cell_name: str, fault=None, seconds=3.0):
    """A CPU run of `cell_name` at the small size, with `fault(entry)`
    applied once set-up is done; returns (result, checks)."""
    from benchmark import run
    config, mix = cell_name.split(".")
    cell = {"name": cell_name, "config": config, "traffic": mix, "chips": 1}
    r = run.Run(cell, 20251018, seconds, False, "cpu", fields_override=SMALL)
    r.mix["warmup_frames"] = 16
    r.sampling.update(rate=0.5, max=3)
    setup = r.entry.setup

    def setup_then_fault():
        setup()
        if fault is not None:
            fault(r.entry)
    r.entry.setup = setup_then_fault
    out = run.execute(r, {})
    metrics = [{"name": "frames_per_s", "unit": "frames/s"},
               {"name": "setup_s", "unit": "s"}]
    return run.result(r, out, metrics)


def _numbers(checks):
    skip = {"captures_in_window", "growths_in_window", "frames_compared",
            "keyframe_share_below", "keyframe_share_above"}
    return {k: c for k, c in checks.items() if k not in skip}


def test_reference_agrees_with_the_programs_cpu_path():
    """The program on the CPU, judged by the frozen reference on the same
    inputs: extraction, K1's matches and the tracked pose agree exactly."""
    torch.manual_seed(0)
    res, checks = _small_run(CELL)
    nums = _numbers(checks)
    assert {"kp_mismatch", "desc_bit_mismatch", "match_mismatch", "pose_dt",
            "pose_dr", "inlier_gap"} <= set(nums)
    assert all(c["value"] == 0 for c in nums.values()), nums
    assert checks["frames_compared"]["value"] >= 1


def _state_unchanged(entry, mp):
    """The tracking step hands back the pose it was given."""
    from plslam_tpu_torch.models import tracking
    track = tracking.track_local_map

    def unchanged(cam, ms, feats, T_last, **kw):
        out = track(cam, ms, feats, T_last, **kw)
        if isinstance(out, tuple) and not hasattr(out, "T"):
            res, ms2 = out
            return res._replace(T=T_last.clone()), ms2
        return out._replace(T=T_last.clone())
    mp.setattr(tracking, "track_local_map", unchanged)


def _answer_altered(entry, mp):
    """The tracked pose is moved by 2 mm where it is produced."""
    from plslam_tpu_torch.models import tracking
    track = tracking.track_local_map

    def altered(cam, ms, feats, T_last, **kw):
        out = track(cam, ms, feats, T_last, **kw)
        res, rest = (out[0], out[1:]) if isinstance(out, tuple) and not \
            hasattr(out, "T") else (out, None)
        T = res.T.clone()
        T[..., 0, 3] += 0.002
        res = res._replace(T=T)
        return (res, *rest) if rest is not None else res
    mp.setattr(tracking, "track_local_map", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _answer_altered],
                         ids=["state-unchanged", "answer-altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    res, checks = _small_run(CELL, lambda entry: fault(entry, monkeypatch))
    assert res["correct"] is False
    failing = [k for k, c in _numbers(checks).items()
               if c["limit"] is not None and c["value"] > c["limit"]]
    assert failing, checks


@pytest.mark.cuda
def test_a_short_run_of_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         CELL, "--seed", "4242424242", "--seconds",
         "3", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["device"]["platform"] == "gpu" and res["attempted"] > 0
    assert set(res["metrics"]) == {"frames_per_s", "setup_s"}
    assert list(res)[-1] == "checks"


@pytest.mark.cuda
def test_the_control_is_not_correct():
    """The reference computed with TF32 products, in the program's place,
    fails the cell's limits (benchmark/control.py, one seed, a short
    window)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.control", "--workload",
         CELL, "--seeds", "5151515151",
         "--seconds", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    rows = [json.loads(l) for l in out.stdout.splitlines()
            if l.startswith("{")]
    assert rows and all(r["control_correct"] is False for r in rows)
