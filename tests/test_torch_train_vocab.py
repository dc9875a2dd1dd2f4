"""The vocabulary trainer (``ccm_slam_tpu_torch.train_vocab``) against the
reference's ``scripts/train_vocab.py`` loop through the JAX package, on the
CPU at a small size: one world, one seed, 2 frames at half resolution, 300
features.

Tolerances: the frames and ORB features as ``test_torch_frontend.py``'s
(valid masks >= 99% equal; on shared valid slots >= 99% of descriptors
equal, mean Hamming distance <= 0.5: rounding at .5 in steered BRIEF and
the raycasters' last bit); the codebook trained from JAX's descriptors with
JAX's ``PRNGKey(1)`` draw exact, its idf to 1e-6.  The default draw (a
``torch.Generator`` seeded 1) is a declared framework divergence: it is
repeatable, and it is not JAX's.
"""

from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccm_slam_tpu.config import CameraConfig as JCameraConfig
from ccm_slam_tpu.config import scaled_camera as j_scaled_camera
from ccm_slam_tpu.io.rendered import RenderedSequence as JRenderedSequence
from ccm_slam_tpu.ops import bow as jbow
from ccm_slam_tpu.ops import orb as jorb
from ccm_slam_tpu_torch import train_vocab as tv
from ccm_slam_tpu_torch.ops import bow, hamming
from ccm_slam_tpu_torch.ops.orb import FrameFeatures

WORLD, SEED, N_FRAMES, N_FEAT, FACTOR = "corridor", 0, 2, 300, 0.5


def jax_extract():
    """JAX's ``orb.extract`` at this file's settings, compiled for the
    frame shape."""
    cam = j_scaled_camera(JCameraConfig(), factor=FACTOR)
    fn = jax.jit(lambda img: jorb.extract(img, n_features=N_FEAT, n_levels=8, capacity=1024))
    return fn.lower(jax.ShapeDtypeStruct((cam.height, cam.width), jnp.float32)).compile()


@pytest.fixture(scope="module")
def both():
    """(the port's collection, its features per frame), and the reference's
    loop through the JAX package: per frame (desc, valid) as numpy, then its
    valid descriptors, JAX's codebook of them at 64 words and 3 iterations
    (``PRNGKey(1)``) and that key's draw.  JAX's extractor compiles in a
    thread (most of this file's time) while both packages render their own
    frames and the port extracts its features on two torch threads."""
    seen = []

    def recorded(*args, **kw):
        seen.extend(port_features(*args, **kw))
        return seen[-N_FRAMES:]

    threads = torch.get_num_threads()
    torch.set_num_threads(2)  # beside the compile: no spinning of idle torch threads
    with ThreadPoolExecutor(1) as pool:
        compiling = pool.submit(jax_extract)
        seq = JRenderedSequence(world=WORLD, seed=SEED, n_frames=N_FRAMES,
                                cam=j_scaled_camera(JCameraConfig(), factor=FACTOR))
        images = [seq.render_frame(i) for i in range(N_FRAMES)]
        port_features = tv.sequence_features
        tv.sequence_features = recorded
        try:
            descs = tv.collect_descriptors((WORLD,), (SEED,), N_FRAMES, N_FEAT, FACTOR, "cpu")
        finally:
            tv.sequence_features = port_features
            torch.set_num_threads(threads)
        extract = compiling.result()
    ref = []
    for img in images:
        f = extract(jnp.asarray(img, jnp.float32))
        ref.append((np.array(f.desc), np.array(f.valid)))
    jdescs = np.concatenate([d[v] for d, v in ref])
    key = jax.random.PRNGKey(tv.TRAIN_SEED)
    book = jbow.train_vocabulary_large(key, jnp.asarray(jdescs), n_words=64, iters=3,
                                       block=1024)
    perm = jax.random.choice(key, len(jdescs), (64,), replace=False)
    return (descs, seen), (ref, (jdescs, jax.device_get(book), np.array(perm)))


@pytest.fixture(scope="module")
def frames(both):
    (descs, ours), (ref, _) = both
    return descs, ours, ref


@pytest.fixture(scope="module")
def jax_codebook(both):
    return both[1][1]


def test_collect_descriptors_matches_the_reference_loop(frames):
    """Over the collection's slots.  Frame 1 alone has 4 of its 300 shared
    descriptors apart (mean distance 0.56): a few pixels of the port's
    raycast round to the other grey level than the XLA raycaster's, which
    moves keypoint angles; the port's ORB on JAX's own frame 1 differs in
    one bit."""
    descs, ours, ref = frames
    assert len(ours) == N_FRAMES
    valid = np.concatenate([f.valid.numpy() for f in ours])
    v_ref = np.concatenate([v for _, v in ref])
    assert v_ref.sum() > 400
    assert (valid == v_ref).mean() >= 0.99
    shared = valid & v_ref
    dist = hamming.hamming_pairwise(torch.cat([f.desc for f in ours]),
                                    torch.as_tensor(np.concatenate([d for d, _ in ref])))
    dist = dist.numpy()[shared]
    assert (dist == 0).mean() >= 0.99 and dist.mean() <= 0.5
    assert descs.dtype == torch.uint8 and descs.device.type == "cpu"
    assert torch.equal(descs, torch.cat([f.desc[f.valid] for f in ours]))
    assert abs(len(descs) - sum(int(v.sum()) for _, v in ref)) <= 0.01 * len(descs)


def test_collect_descriptors_orders_world_seed_frame_slot(monkeypatch, capsys):
    """Each frame's valid slots in slot order, frames in order, seeds within
    worlds (each descriptor here spells its own world, seed, frame, slot)."""
    def fake(world, seed, n_frames, n_feat, factor, device=None, cache_dir=None):
        out = []
        for i in range(n_frames):
            desc = torch.zeros(6, 32, dtype=torch.uint8)
            desc[:, 0] = ("corridor", "loop").index(world)
            desc[:, 1], desc[:, 2], desc[:, 3] = seed, i, torch.arange(6)
            valid = torch.tensor([True, False, True, True, False, True])
            z = torch.zeros(6)
            out.append(FrameFeatures(xy=torch.zeros(6, 2), response=z, octave=z.int(),
                                     angle=z, desc=desc, valid=valid))
        return out

    monkeypatch.setattr(tv, "sequence_features", fake)
    descs = tv.collect_descriptors(("corridor", "loop"), (4, 7), 3, 9, 1.0, "cpu")
    want = [(w, s, i, k) for w in (0, 1) for s in (4, 7) for i in range(3) for k in (0, 2, 3, 5)]
    assert descs[:, :4].tolist() == [list(x) for x in want]
    lines = capsys.readouterr().out.splitlines()
    assert [x.split(" (")[0] for x in lines] == [
        f"{w}/{s}: 3 frames, {12 * n} descs so far"
        for n, (w, s) in enumerate([(w, s) for w in ("corridor", "loop") for s in (4, 7)], 1)]


@pytest.mark.parametrize("limit", [300, 1000, 5000])
def test_subsample_draws_the_reference_indices(limit):
    n = 1000
    descs = np.zeros((n, 32), np.uint8)
    descs[:, 0], descs[:, 1] = np.arange(n) % 256, np.arange(n) // 256
    ours = tv.subsample(torch.as_tensor(descs), limit).numpy()
    ref = descs
    rs = np.random.RandomState(0)  # the reference's lines
    if len(ref) > limit:
        ref = ref[rs.choice(len(ref), limit, replace=False)]
    np.testing.assert_array_equal(ours, ref)
    assert len(ours) == min(n, limit)


def test_train_with_the_reference_draw_matches_jax(jax_codebook):
    """JAX's descriptors, and JAX's centroid draw passed as ``perm``: the
    port's codebook is JAX's."""
    descs, ref, perm = jax_codebook
    ours = tv.train(torch.as_tensor(descs), "cpu", perm=perm, n_words=64, iters=3)
    np.testing.assert_array_equal(ours.words.numpy(), np.asarray(ref.words))
    np.testing.assert_allclose(ours.idf.numpy(), np.asarray(ref.idf), rtol=1e-6, atol=1e-6)


def test_default_draw_is_seeded_and_repeatable_but_not_jax(jax_codebook):
    """The declared framework divergence: without ``perm`` the centroids come
    from a ``torch.Generator`` seeded 1, not from ``PRNGKey(1)``."""
    descs, ref, _ = jax_codebook
    descs = torch.as_tensor(descs)
    a = tv.train(descs, "cpu", n_words=64, iters=3)
    b = tv.train(descs, "cpu", n_words=64, iters=3)
    c = tv.train(descs, "cpu", n_words=64, iters=3,
                 generator=torch.Generator().manual_seed(tv.TRAIN_SEED))
    assert torch.equal(a.words, b.words) and torch.equal(a.idf, b.idf)
    assert torch.equal(a.words, c.words)
    assert not np.array_equal(a.words.numpy(), np.asarray(ref.words))


def test_main_writes_a_codebook_and_keeps_vocab32k(tmp_path, monkeypatch, capsys):
    for name, value in (("WORLDS", ("loop",)), ("SEEDS", (1,)), ("N_PER_SEQ", 1),
                        ("N_FEAT", 200), ("FACTOR", 0.25), ("N_WORDS", 32), ("ITERS", 2)):
        monkeypatch.setattr(tv, name, value)
    before = Path(bow.VOCAB32K).read_bytes()
    out, state = tmp_path / "v.npz", {}
    assert tv.main(["cpu", "--out", out], state) == 0
    lines = capsys.readouterr().out.splitlines()
    n = state["n_descs"]
    assert lines[0].startswith(f"loop/1: 1 frames, {n} descs so far")
    assert lines[1] == f"total descriptors: {n}" and n == state["n_train"] > 32
    assert lines[2].startswith("trained 32 words in ")
    assert lines[3] == f"saved {out} {out.stat().st_size} bytes"
    v = bow.load_vocabulary(str(out), device="cpu")
    assert v.words.shape == (32, 32) and torch.equal(v.words, state["vocab"].words)
    assert torch.equal(v.idf, state["vocab"].idf)
    assert state["collect_s"] > 0 and state["train_s"] > 0
    # the checked-in codebook: untouched, and still the reference's bytes
    assert Path(bow.VOCAB32K).read_bytes() == before
    assert before == (Path(jbow.__file__).resolve().parents[1] / "data" / "vocab32k.npz"
                      ).read_bytes()
    # without a card, only ``cpu`` runs it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.main(["--out", tmp_path / "w.npz"])
    assert not (tmp_path / "w.npz").exists()
