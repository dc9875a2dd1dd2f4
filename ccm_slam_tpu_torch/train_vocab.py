"""Train the production BoW codebook from rendered-pixel ORB descriptors.

Counterpart of ``scripts/train_vocab.py``.  The reference ships ORBvoc.txt
(a ~1M-leaf DBoW2 tree trained on outdoor imagery, readme.md:102-106); this
trains its flat-codebook analogue, 32,768 words, on descriptors that the
port's own ORB pipeline extracts from the rendered worlds (corridor and
loop, texture seeds 0-2), so training and deployment see the same
descriptor statistics.

    python -m ccm_slam_tpu_torch.train_vocab [cpu] [--out PATH]

Runs on ``cuda:0`` (raising without a card) unless ``cpu`` is given, the
reference's own switch.  Frames are raycast on the run's device
(``RenderedSequence(backend="torch")``), and every nearest-word search of
the training is one ``hamming_top2`` launch per 8,192 descriptors
(``bow.train_vocabulary_large``).  ``CCM_RENDER_CACHE`` names a directory
that keeps rendered frames between runs (the reference's
``/tmp/ccm_render_cache``), as for the runner.

The default output is the port's checked-in ``data/vocab32k.npz``
(``bow.VOCAB32K``), a byte-for-byte copy of the reference's codebook: give
``--out`` for anything but a deliberate retrain.  The centroid seeds come
from a ``torch.Generator`` seeded 1 where the reference draws them from
``jax.random.PRNGKey(1)``.  The two draws differ, so a retrain here gives
other words than the reference's; ``train(..., perm=)`` takes the
reference's draw and then gives its codebook.

``main(argv)`` runs in process and returns 0; ``main(argv, state)`` also
fills the dict ``state`` with the descriptor counts, the codebook, the path
written and the walls of collection and training (seconds: CUDA events
with a sync at each end on the card, the host clock on the CPU).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from .config import CameraConfig, scaled_camera
from .device import resolve_device
from .io.rendered import RenderedSequence
from .ops import bow, orb

# the reference's settings (scripts/train_vocab.py)
WORLDS = ("corridor", "loop")
SEEDS = (0, 1, 2)
N_PER_SEQ = 48      # frames per sequence
N_FEAT = 600        # ORB features per frame
FACTOR = 1.0        # 752x480
LIMIT = 250_000     # descriptors kept for training
N_WORDS = 32768
ITERS = 6
TRAIN_SEED = 1      # the centroid draw (the reference's PRNGKey(1))


def sequence_features(world, seed, n_frames, n_feat, factor, device=None, cache_dir=None):
    """The ORB features (``orb.extract`` with 8 levels, capacity 1,024) of
    every frame of ``RenderedSequence(world, seed, n_frames)`` at
    ``scaled_camera(factor=factor)``, in frame order, raycast and extracted
    on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    seq = RenderedSequence(world=world, seed=seed, n_frames=n_frames,
                           cam=scaled_camera(CameraConfig(), factor=factor), backend="torch",
                           device=dev, cache_dir=cache_dir)
    return [orb.extract(seq.render_frame(i), n_features=n_feat, n_levels=8, capacity=1024)
            for i in range(n_frames)]


def collect_descriptors(worlds=WORLDS, seeds=SEEDS, n_per_seq=N_PER_SEQ, n_feat=N_FEAT,
                        factor=FACTOR, device=None, cache_dir=None):
    """[N, 32] uint8 on ``device``: the valid descriptors of every frame,
    world by world, then seed, frame and feature slot (the reference's
    order).  Prints one line per sequence, as the reference does."""
    parts, total = [], 0
    for world in worlds:
        for seed in seeds:
            t0 = time.time()
            for f in sequence_features(world, seed, n_per_seq, n_feat, factor, device,
                                       cache_dir):
                parts.append(f.desc[f.valid])
                total += parts[-1].shape[0]
            print(f"{world}/{seed}: {n_per_seq} frames, {total} descs so far "
                  f"({time.time() - t0:.0f}s)", flush=True)
    return torch.cat(parts)


def subsample(descs, limit: int = LIMIT):
    """At most ``limit`` rows: above it, the rows that
    ``np.random.RandomState(0).choice(len, limit, replace=False)`` picks, in
    its order (the reference's sample)."""
    if descs.shape[0] <= limit:
        return descs
    idx = np.random.RandomState(0).choice(descs.shape[0], limit, replace=False)
    return descs[torch.as_tensor(idx, device=descs.device)]


def train(descs, device, generator=None, perm=None, n_words: int = N_WORDS,
          iters: int = ITERS) -> bow.Vocabulary:
    """``bow.train_vocabulary_large`` over ``descs`` on ``device``.  ``perm``
    [n_words] seeds the centroids (the reference's draw, for parity); else
    they are drawn by ``generator``, by default a ``torch.Generator`` on the
    device seeded ``TRAIN_SEED``."""
    dev = resolve_device(device)
    descs = descs.to(dev)
    if perm is not None:
        perm = torch.as_tensor(perm if isinstance(perm, torch.Tensor) else np.array(perm),
                               device=dev)
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    return bow.train_vocabulary_large(descs, n_words=n_words, iters=iters, perm=perm,
                                      generator=generator)


def _timed(fn, dev):
    """(fn(), seconds): CUDA events with a sync at each end on the card, the
    host clock on the CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return out, start.elapsed_time(end) / 1e3


def main(argv=None, state=None) -> int:
    ap = argparse.ArgumentParser(description="Train the 32,768-word BoW codebook from "
                                 "rendered-pixel ORB descriptors.")
    ap.add_argument("where", nargs="?", choices=["cpu"], help="run on the CPU (else cuda:0)")
    ap.add_argument("--out", default=bow.VOCAB32K,
                    help="the .npz to write (default: the port's checked-in codebook)")
    args = ap.parse_args(sys.argv[1:] if argv is None else [str(a) for a in argv])
    dev = torch.device("cpu") if args.where == "cpu" else resolve_device(None)
    state = {} if state is None else state

    descs, state["collect_s"] = _timed(lambda: collect_descriptors(
        WORLDS, SEEDS, N_PER_SEQ, N_FEAT, FACTOR, dev,
        os.environ.get("CCM_RENDER_CACHE") or None), dev)
    state["n_descs"] = descs.shape[0]
    print("total descriptors:", descs.shape[0], flush=True)
    descs = subsample(descs, LIMIT)
    state["n_train"] = descs.shape[0]
    vocab, state["train_s"] = _timed(lambda: train(descs, dev, n_words=N_WORDS, iters=ITERS),
                                     dev)
    print(f"trained {N_WORDS} words in {state['train_s']:.1f}s", flush=True)
    out = os.path.abspath(args.out)
    out = out if out.endswith(".npz") else out + ".npz"  # as np.savez names it
    os.makedirs(os.path.dirname(out), exist_ok=True)
    bow.save_vocabulary(out, vocab)
    print("saved", out, os.path.getsize(out), "bytes", flush=True)
    state.update(vocab=vocab, out=out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
