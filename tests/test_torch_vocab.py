"""The port's DBoW2 tree vocabulary (`vocab/orbvoc.py`) and its dispatch
behind `bow.set_vocabulary`, against the JAX package's.

Tolerances and why:
- training, the text format and the tree descent are integer work on the
  same numpy draws: vocabularies, files and word ids bit-equal (port tensor
  descent, JAX descent and the greedy host descent);
- the port sums a BoW vector's float32 idf weights in float64 (so a GPU
  gives the CPU's bits), the JAX package in float32: within 1e-6.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_threads import one_thread  # noqa: F401


def _rand_bits(rng, n):
    return (rng.random((n, 256)) < 0.5).astype(np.uint8)


@pytest.fixture
def installed():
    """Installs vocabularies in both packages; restores the LSH words."""
    from plslam_tpu.vocab import bow as jbow
    from plslam_tpu_torch.vocab import bow as tbow
    try:
        yield lambda vj, vt: (jbow.set_vocabulary(vj),
                              tbow.set_vocabulary(vt))
    finally:
        jbow.set_vocabulary(None)
        tbow.set_vocabulary(None)


@pytest.fixture(scope="module")
def vocabularies(tmp_path_factory):
    from plslam_tpu.vocab import orbvoc as jvoc
    from plslam_tpu_torch.vocab import orbvoc as tvoc
    rng = np.random.default_rng(0)
    imgs = [_rand_bits(rng, 120) for _ in range(6)]
    vj = jvoc.train(imgs, k=4, L=3, seed=1)
    vt = tvoc.train(imgs, k=4, L=3, seed=1)
    d = tmp_path_factory.mktemp("voc")
    jvoc.save_text(vj, str(d / "jax.txt"))
    tvoc.save_text(vt, str(d / "port.txt"))
    return dict(vj=vj, vt=vt, dir=d, q=_rand_bits(rng, 64),
                valid=rng.random(64) < 0.8)


def test_text_roundtrip_and_descent_parity(vocabularies):
    from plslam_tpu.vocab import orbvoc as jvoc
    from plslam_tpu_torch.vocab import orbvoc as tvoc
    v, d, q = vocabularies, vocabularies["dir"], vocabularies["q"]
    assert v["vt"].n_words == v["vj"].n_words > 16
    assert (d / "port.txt").read_text() == (d / "jax.txt").read_text()
    vt2 = tvoc.load_text(str(d / "jax.txt"))
    vj2 = jvoc.load_text(str(d / "port.txt"))
    assert (vt2.k, vt2.L, vt2.n_words) == (vj2.k, vj2.L, vj2.n_words)
    w_port = vt2.words_of(torch.from_numpy(q))
    assert w_port.dtype == torch.int32
    w_jax = np.asarray(vj2.words_of(jnp.asarray(q)))
    np.testing.assert_array_equal(w_port.numpy(), w_jax)
    np.testing.assert_array_equal(w_port.numpy(), tvoc.words_of_np(vt2, q))
    np.testing.assert_array_equal(v["vt"].words_of(torch.from_numpy(q)),
                                  w_port)
    np.testing.assert_array_equal(v["vt"]._weights.numpy(),
                                  np.asarray(v["vj"]._weights))
    np.testing.assert_allclose(vt2._weights.numpy(),
                               v["vt"]._weights.numpy(), rtol=1e-5)


def test_bow_vector_matches_jax_when_installed(vocabularies, installed):
    from plslam_tpu.vocab import bow as jbow
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.vocab import bow as tbow
    v = vocabularies
    q, valid = v["q"], v["valid"]
    lsh = tbow.words_of(torch.from_numpy(q))
    installed(v["vj"], v["vt"])
    assert tbow.N_WORDS == jbow.N_WORDS == v["vt"].n_words
    np.testing.assert_array_equal(
        tbow.words_of(torch.from_numpy(q)).numpy(),
        np.asarray(jbow.words_of(jnp.asarray(q))))
    bt = tbow.bow_vector(torch.from_numpy(q), torch.from_numpy(valid))
    bj = np.asarray(jbow.bow_vector(jnp.asarray(q), jnp.asarray(valid)))
    assert bt.dtype == torch.float32 and bt.shape == (v["vt"].n_words,)
    np.testing.assert_allclose(bt.numpy(), bj, rtol=1e-6, atol=1e-9)
    assert abs(float(bt.sum()) - 1.0) < 1e-6
    # a map allocated now has the vocabulary's width
    ms = mstate.allocate(mstate.MapConfig(max_kf=4, max_pt=16, max_ln=4,
                                          n_kp=8, n_lf=4), "cpu")
    assert ms.kf_bow.shape == (4, v["vt"].n_words)
    installed(None, None)
    assert tbow.N_WORDS == 4096
    assert torch.equal(tbow.words_of(torch.from_numpy(q)), lsh)


def test_bow_vector_under_vmap(vocabularies, installed):
    """The installed vocabulary's BoW vector runs under `torch.func.vmap`
    with the fallback off (the batched keyframe chain computes it)."""
    from plslam_tpu_torch.vocab import bow as tbow
    v = vocabularies
    installed(v["vj"], v["vt"])
    rng = np.random.default_rng(5)
    q = torch.from_numpy(np.stack([v["q"], _rand_bits(rng, 64)]))
    valid = torch.from_numpy(np.stack([v["valid"], rng.random(64) < 0.5]))
    torch._C._functorch._set_vmap_fallback_enabled(False)
    try:
        out = torch.func.vmap(tbow.bow_vector)(q, valid)
        words = torch.func.vmap(tbow.words_of)(q)
    finally:
        torch._C._functorch._set_vmap_fallback_enabled(True)
    for s in range(2):
        assert torch.equal(out[s], tbow.bow_vector(q[s], valid[s]))
        assert torch.equal(words[s], tbow.words_of(q[s]))


def test_bow_retrieval_through_tree_vocabulary(installed):
    """tests/test_orbvoc.py's retrieval bar, through the port: a tree
    trained on every 3rd frame of the photo loop, installed behind
    `bow.set_vocabulary`, precision@1 >= 0.8."""
    from plslam_tpu_torch.datasets import synthetic, textured
    from plslam_tpu_torch.ops import extract
    from plslam_tpu_torch.vocab import bow, orbvoc

    scene = textured.make_photo_scene(seed=3)
    n = 24
    Ts = synthetic.trajectory(n, "loop", amplitude=2.2)
    ext = extract.PointExtractor(
        extract.ExtractorConfig(n_features=512, n_levels=3), 480, 640)
    feats = [ext(torch.from_numpy(synthetic.render(scene, T))) for T in Ts]
    voc = orbvoc.train([f.desc.numpy()[f.valid.numpy()] for f in feats][::3],
                       k=8, L=3, seed=0)
    installed(None, voc)
    bows = torch.stack([bow.bow_vector(f.desc, f.valid) for f in feats]).numpy()

    C = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    Z = np.stack([T[:3, :3].T @ np.array([0, 0, 1.0]) for T in Ts])
    ang = np.arccos(np.clip(Z @ Z.T, -1, 1))
    dist = np.linalg.norm(C[:, None] - C[None, :], axis=-1)
    relevant = (ang < 0.25) & (dist < 0.6)
    hits1 = total = 0
    for i in range(n):
        cand = [j for j in range(n) if abs(i - j) > 4]
        if not any(relevant[i, j] for j in cand):
            continue
        sc = np.minimum(bows[i][None, :], bows[cand]).sum(-1)
        total += 1
        hits1 += bool(relevant[i, cand[int(np.argmax(sc))]])
    assert total >= 8
    assert hits1 / total >= 0.8, f"precision@1 {hits1 / total:.2f}"
