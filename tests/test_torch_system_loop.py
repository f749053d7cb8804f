"""The port's `System.track_monocular` against the JAX package's with loop
closing (detection on every keyframe), growth (5 keyframe slots) and the
young-map global BA up to the 4th keyframe on, over the 28 rendered frames
of the system sequence (tests/test_torch_system.py gives the run and its
bounds): the same bounds and the same growth events."""
import pytest

from test_torch_system import LOOP, _assert_within_bounds, _both
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs_loop():
    return _both(LOOP)


def test_system_with_loop_closing_and_growth_matches_jax(runs_loop):
    """Loop closing (detection on every keyframe), growth and the young-map
    global BA on: the same bounds and the same growth events."""
    _, (j, _, _), (t, _, _) = runs_loop
    _assert_within_bounds(runs_loop)
    assert t.n_growths == j.n_growths >= 1
    assert t.map_cfg._asdict() == j.map_cfg._asdict()
    assert t.map_cfg.max_kf > LOOP["max_kf"]
    assert t.loop_closer is not None and t.loop_closer.n_loops == 0
    assert t.ms.kf_T.shape[0] == t.map_cfg.max_kf
