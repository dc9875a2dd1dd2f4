"""Two plain formulations of the dense Hamming distance, timed on the card.

``ops/hamming.py``'s ``hamming_cross`` and ``hamming_self`` can compute
their integers two ways: XOR + popcount over the descriptors' four 64-bit
words (in row chunks, so the [chunk, D, 4] planes stay bounded), or one
float32 product of +-1 bit planes, exact because every partial sum of +-1
terms is an integer of magnitude <= 256 (TF32 off).  This script checks
that both give the same integers and times each with CUDA events at the
shapes the port calls them with: ``search_for_initialization`` /
``search_for_triangulation`` and ``match_brute``'s plain best-2 (1,000 x
1,000 and 1,024 x 1,024), the tracker's window search (4,096 x 1,000),
``hamming_top2_plain`` at the vocabulary bootstrap (163,840 x 1,024) and
at relocalization (1,024 x 16,384), and ``compute_distinctive_descriptors``'
``hamming_self`` over 24,576 landmarks of 16 and 24 observations in
chunks of 2,048.  Prints one JSON line per shape and the card's name and
power limit.

    python -m tools.hamming_paths
"""

from __future__ import annotations

import json
import subprocess

import torch

from ccm_slam_tpu_torch.ops import hamming

CHUNK_BYTES = 1 << 27  # XOR planes held at once, as the XOR form chunks them
SELF_CHUNK = 2048      # compute_distinctive_descriptors' landmark chunk


def cross_xor(q, d):
    Q, D = q.shape[0], d.shape[0]
    out = torch.empty(Q, D, dtype=torch.int32, device=q.device)
    q64, d64 = hamming._words(q), hamming._words(d)
    step = max(1, CHUNK_BYTES // max(D * 32, 1))
    for q0 in range(0, Q, step):
        x = q64[q0:q0 + step, None, :] ^ d64[None]
        out[q0:q0 + step] = torch.sum(hamming.popcount64(x), dim=-1, dtype=torch.int32)
    return out


def cross_signs(q, d):
    return hamming._sign_distance(hamming._signs(q) @ hamming._signs(d).T)


def self_xor(x):
    return hamming.hamming_pairwise(x[:, :, None, :], x[:, None, :, :])


def self_signs(x):
    s = hamming._signs(x)
    return hamming._sign_distance(s @ s.transpose(1, 2))


def chunked(fn, x):
    return [fn(x[b:b + SELF_CHUNK]) for b in range(0, x.shape[0], SELF_CHUNK)]


def event_ms(fn, reps=20):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def main():
    assert torch.cuda.is_available(), "needs a CUDA card"
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    g = torch.Generator(device="cpu").manual_seed(3)
    rnd = lambda *s: torch.randint(0, 256, s, generator=g, dtype=torch.uint8).to(dev)
    for name, Q, D in (("init/triangulation", 1000, 1000), ("match_brute plain", 1024, 1024),
                       ("window search", 4096, 1000), ("relocalization plain", 1024, 16384),
                       ("bootstrap plain", 163840, 1024)):
        q, d = rnd(Q, 32), rnd(D, 32)
        equal = torch.equal(cross_xor(q, d), cross_signs(q, d))
        print(json.dumps(dict(fn="hamming_cross", shape=name, Q=Q, D=D, equal=equal,
                              xor_ms=event_ms(lambda: cross_xor(q, d)),
                              signs_ms=event_ms(lambda: cross_signs(q, d)),
                              card=card)), flush=True)
    for O in (16, 24):
        x = rnd(24576, O, 32)
        equal = all(torch.equal(a, b) for a, b in zip(chunked(self_xor, x), chunked(self_signs, x)))
        print(json.dumps(dict(fn="hamming_self", shape=f"24576 x {O} in chunks of {SELF_CHUNK}",
                              equal=equal, xor_ms=event_ms(lambda: chunked(self_xor, x)),
                              signs_ms=event_ms(lambda: chunked(self_signs, x)), card=card)),
              flush=True)


if __name__ == "__main__":
    main()
