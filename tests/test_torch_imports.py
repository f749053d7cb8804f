"""The PyTorch port stands alone: importing every one of its modules, and the
scripts that drive it on the card, pulls in neither jax nor plslam_tpu."""
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
    return mods + ["chip_smoke", "profile_torch_step", "compare_torch_slice"]


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
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == len(mods)
