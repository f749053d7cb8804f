"""The PyTorch port stands alone: importing every one of its modules, and the
scripts and card tests that drive it on the card, pulls in neither jax nor
plslam_tpu."""
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _port_modules():
    pkg = ROOT / "plslam_tpu_torch"
    mods = []
    for path in sorted(pkg.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods + ["chip_smoke", "profile_torch_step", "compare_torch_slice",
                   "test_torch_gates", "torch_gate_fixtures"]


def test_port_imports_no_jax():
    mods = _port_modules()
    assert "plslam_tpu_torch.ops.gated_match" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'plslam_tpu'))\n"
            "assert not bad, bad\n"
            "print(len(" + repr(mods) + "))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods)


def test_port_extracts_without_the_jax_package(tmp_path):
    """A tree that holds only the port extracts keypoints at the defaults
    (the learned descriptor pattern is the port's own file)."""
    import shutil
    shutil.copytree(ROOT / "plslam_tpu_torch", tmp_path / "plslam_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert not (tmp_path / "plslam_tpu").exists()
    code = (
        "import sys, torch\n"
        "from plslam_tpu_torch.datasets import synthetic\n"
        "from plslam_tpu_torch.ops import extract\n"
        "cfg = extract.ExtractorConfig()\n"
        "assert cfg.desc_pattern == 'learned'\n"
        "img = synthetic.render(synthetic.make_scene(seed=0),\n"
        "                       synthetic.trajectory(2, 'orbit')[0])\n"
        "f = extract.PointExtractor(cfg, 480, 640)(torch.from_numpy(img))\n"
        "assert not [m for m in sys.modules\n"
        "            if m.split('.')[0] in ('jax', 'plslam_tpu')]\n"
        "print(int(f.valid.sum()))\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) > 500


def test_learned_pattern_is_the_jax_package_file():
    a = (ROOT / "plslam_tpu" / "ops" / "learned_pattern.npy").read_bytes()
    b = (ROOT / "plslam_tpu_torch" / "ops" / "learned_pattern.npy").read_bytes()
    assert a == b
