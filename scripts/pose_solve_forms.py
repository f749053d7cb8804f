"""The pose solve's normal equations in three forms, compared on the CPU.

`optim/pose_opt._normal_equations` of the port forms H and J^T r from one
[J | r] product per edge kind ("jr"), whose sums run in one order whether
or not the call is batched over streams. Before it took H and b from two
einsums ("parent", the JAX package's form). "f64" takes both einsums in
float64 and rounds the result to float32.

Two measurements:

- As a script, the error of "parent" and "jr" against the float64 normal
  equations and against the float64 LM step, on every pose optimization
  of tests/test_torch_multistream.py's three streams tracked one at a time
  (4 frames each, the first with the keyframe chain):

      python scripts/pose_solve_forms.py

- As a pytest plugin, the port's parity tests run with one form, and every
  `np.testing.assert_allclose` logs its largest gap, one JSON line per
  call, to $GAPLOG; run it once per form and compare the logs:

      FORM=parent GAPLOG=build/gaps_parent.jsonl PYTHONPATH=scripts \\
          JAX_PLATFORMS=cpu python -m pytest -p pose_solve_forms \\
          tests/test_torch_tracking.py tests/test_torch_dispatch.py ...
      python scripts/pose_solve_forms.py --compare build/gaps_*.jsonl
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def normal_equations(po, form: str):
    """`_normal_equations` of `plslam_tpu_torch.optim.pose_opt` (module
    `po`) with H and b in `form` ("jr" is the module's own)."""
    own = po._normal_equations
    R = po.residuals

    def ne(cam, T, obs, pt_in, ln_in, robust):
        if form == "jr":
            return own(cam, T, obs, pt_in, ln_in, robust)
        r_p, J_p, z_p, gate_p = po._pt_edges(cam, T, obs)
        w_p = 1.0 / obs.pt_sigma2
        chi2_p = torch.sum(r_p * r_p, dim=-1) * w_p
        m_p = (obs.pt_mask & pt_in & (z_p > 0)).to(torch.float32) * w_p
        if robust:
            m_p = m_p * R.huber_weight(chi2_p, gate_p)
        r_l, J_l, _, z_l = R.line_endpoint_residual(cam, T, obs.ln_xyz,
                                                    obs.ln_l2d)
        chi2_l = r_l * r_l * obs.ln_info
        m_l = (obs.ln_mask & ln_in & (z_l > 0)).to(torch.float32) \
            * obs.ln_info
        if robust:
            m_l = m_l * R.huber_weight(chi2_l, po.CHI2_LINE)
        H, b = _einsums(J_p, r_p, m_p, J_l, r_l, m_l,
                        torch.float64 if form == "f64" else torch.float32)
        return (H.float(), b.float(), chi2_p, chi2_l, z_p, z_l, gate_p)
    return ne


def _einsums(J_p, r_p, m_p, J_l, r_l, m_l, dtype):
    """The JAX package's H and b, in `dtype`."""
    J_p, r_p, m_p, J_l, r_l, m_l = (x.to(dtype) for x in
                                    (J_p, r_p, m_p, J_l, r_l, m_l))
    H = torch.einsum("nij,nik,n->jk", J_p, J_p, m_p) \
        + torch.einsum("nj,nk,n->jk", J_l, J_l, m_l)
    b = -torch.einsum("nij,ni,n->j", J_p, r_p, m_p) \
        - torch.einsum("nj,n,n->j", J_l, r_l, m_l)
    return H, b


# ---- pytest plugin: FORM picks the form, GAPLOG receives the gaps ----

_current = {"id": None, "k": 0}


def pytest_configure(config):
    from plslam_tpu_torch.optim import pose_opt as po
    form, log = os.environ.get("FORM", "jr"), os.environ["GAPLOG"]
    po._normal_equations = normal_equations(po, form)
    check = np.testing.assert_allclose

    def logged(actual, desired, *args, **kwargs):
        a = np.asarray(actual, np.float64)
        d = np.asarray(desired, np.float64)
        if a.shape == d.shape and a.size:
            _current["k"] += 1
            with open(log, "a") as f:
                f.write(json.dumps(dict(
                    form=form, id=_current["id"], k=_current["k"],
                    gap=float(np.nanmax(np.abs(a - d))))) + "\n")
        return check(actual, desired, *args, **kwargs)
    np.testing.assert_allclose = logged


def pytest_runtest_setup(item):
    _current["id"], _current["k"] = item.nodeid, 0


# ---- the script ----

def accuracy():
    sys.path[:0] = [os.path.join(ROOT, "tests"), ROOT]
    torch.set_num_threads(1)
    import test_torch_multistream as scene
    from plslam_tpu_torch.models import system
    from plslam_tpu_torch.optim import pose_opt as po
    from plslam_tpu_torch.parallel import multistream
    own = po._normal_equations
    errs = {"parent": [], "jr": []}

    def measuring(cam, T, obs, pt_in, ln_in, robust):
        out = own(cam, T, obs, pt_in, ln_in, robust)
        r_p, J_p, z_p, gate_p = po._pt_edges(cam, T, obs)
        w_p = 1.0 / obs.pt_sigma2
        chi2_p = torch.sum(r_p * r_p, dim=-1) * w_p
        m_p = (obs.pt_mask & pt_in & (z_p > 0)).to(torch.float32) * w_p
        if robust:
            m_p = m_p * po.residuals.huber_weight(chi2_p, gate_p)
        r_l, J_l, _, z_l = po.residuals.line_endpoint_residual(
            cam, T, obs.ln_xyz, obs.ln_l2d)
        chi2_l = r_l * r_l * obs.ln_info
        m_l = (obs.ln_mask & ln_in & (z_l > 0)).to(torch.float32) \
            * obs.ln_info
        if robust:
            m_l = m_l * po.residuals.huber_weight(chi2_l, po.CHI2_LINE)
        args = (J_p, r_p, m_p, J_l, r_l, m_l)
        H64, b64 = _einsums(*args, torch.float64)
        eye = 1e-8 * torch.eye(6, dtype=torch.float64)
        x64 = torch.linalg.solve(H64 + eye, b64)
        for form, (H, b) in (("parent", _einsums(*args, torch.float32)),
                             ("jr", out[:2])):
            H, b = H.double(), b.double()
            x = torch.linalg.solve(H + eye, b)
            errs[form].append([
                float((H - H64).abs().max() / H64.abs().max()),
                float((b - b64).abs().max() / b64.abs().max()),
                float((x - x64).abs().max() / x64.abs().max())])
        return out
    po._normal_equations = measuring
    _, data = scene._render()
    maps = [scene.depth_map(scene.CFG, f[0], d) for f, d in data]
    bt = multistream.BatchedTracker(system.SLAMConfig(**scene.CFG), 1,
                                    device="cpu")
    for (frames, _), ms in zip(data, maps):
        T = vel = torch.eye(4)
        for j in range(scene.N_STEPS):
            T, vel, _ = bt._stream_step(
                ms, torch.from_numpy(frames[1 + j]), T, vel,
                torch.tensor(j, dtype=torch.int32), with_kf=j % 5 == 0)
    e = {k: np.array(v) for k, v in errs.items()}
    for form, a in e.items():
        print(f"{form}: {len(a)} solves; error against float64, median / "
              f"max: H {np.median(a[:, 0]):.2e} / {a[:, 0].max():.2e}, b "
              f"{np.median(a[:, 1]):.2e} / {a[:, 1].max():.2e}, LM step "
              f"{np.median(a[:, 2]):.2e} / {a[:, 2].max():.2e}")
    for i, name in enumerate(("H", "b", "LM step")):
        print(f"jr no farther than parent from float64 ({name}): "
              f"{(e['jr'][:, i] <= e['parent'][:, i]).mean():.3f}")


def compare(paths):
    gaps = collections.defaultdict(dict)
    for p in paths:
        for line in open(p):
            r = json.loads(line)
            gaps[(r["id"], r["k"])][r["form"]] = r["gap"]
    forms = sorted({f for g in gaps.values() for f in g})
    rows = [[g[f] for f in forms] for g in gaps.values()
            if len(g) == len(forms) and len(set(g.values())) > 1]
    a = np.array(rows)
    print(f"{len(a)} comparisons with JAX where the forms differ; forms "
          f"{forms}; largest gap {' '.join(f'{x:.2e}' for x in a.max(0))}")
    for i, f in enumerate(forms):
        for j, g in enumerate(forms):
            if i < j:
                ratio = np.exp(np.mean(np.log((a[:, j] + 1e-9)
                                              / (a[:, i] + 1e-9))))
                print(f"{g} closer to JAX than {f} in "
                      f"{int((a[:, j] < a[:, i]).sum())}, farther in "
                      f"{int((a[:, j] > a[:, i]).sum())}; geometric mean "
                      f"of the gap ratio {g} / {f} {ratio:.3f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", nargs="+", metavar="GAPLOG")
    opts = ap.parse_args()
    compare(opts.compare) if opts.compare else accuracy()
