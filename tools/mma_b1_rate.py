"""The rate of the tensor cores' 1-bit product on the card: ``hamming_top2``'s floor.

    python3 tools/mma_b1_rate.py

Builds ``tools/mma_b1_rate.cu`` with ``nvcc`` (sm_90a) into ``build/tools/``,
checks one 16 x 8 tile of ``mma.sync ... m16n8k256 ... b1 ... and.popc``
against popcounts on the host (with the fragment mapping that
``hamming_top2``'s kernel uses), then times a loop of independent
instructions over the whole card with CUDA events.  Prints one JSON line:
instructions per second, (query, target) pairs per second (128 an
instruction), and instructions per clock per SM at the card's largest SM
clock, with the card's name and power limit.  ``chip_smoke.py`` and
``tools/time_ba_kernels.py`` call ``measure`` and reckon ``hamming_top2``'s
bound from the pairs per second it returns.  Needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().with_suffix(".cu")
BUILD_DIR = SRC.parents[1] / "build" / "tools"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v")
PAIRS_PER_MMA = 16 * 8   # one m16n8k256 instruction: 16 rows x 8 columns
TARGET_MS = 50.0         # length of the timed launch


def library_path() -> Path:
    key = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"mma_b1_rate-{key}.so"


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def start_build():
    """Start ``nvcc`` on the probe unless its library is built; returns the
    process (or None), to be passed to ``finish_build``."""
    out = library_path()
    if out.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen([_nvcc(), *FLAGS, "-o", str(tmp), str(SRC)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def finish_build(proc) -> str:
    """Wait for ``start_build``'s process; raises if ``nvcc`` failed.
    Returns the compiler's output (``-Xptxas -v``)."""
    out = library_path()
    if proc is None:
        log = out.with_suffix(".log")
        return log.read_text() if log.is_file() else ""
    stdout, stderr = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {SRC.name} (rc {proc.returncode}):\n{stderr}")
    out.with_suffix(".log").write_text(stdout + stderr)
    os.replace(out.with_suffix(f".{os.getpid()}.tmp"), out)
    return stdout + stderr


def _load():
    finish_build(start_build())
    lib = ctypes.CDLL(str(library_path()))
    P, I = ctypes.c_void_p, ctypes.c_int
    for fn, args in (("ccm_mma_b1_tile", [P] * 4), ("ccm_mma_b1_loop", [I, I, P, P]),
                     ("ccm_mma_b1_chains", [])):
        getattr(lib, fn).argtypes = args
        getattr(lib, fn).restype = I
    return lib


def _call(lib, fn, dev, *args):
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc}")


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def check_tile(lib, dev) -> bool:
    """One instruction on random bits against popc(a & b) on the host."""
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2**32, (16, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, (8, 8), dtype=np.uint64).astype(np.uint32)
    want = np.array([[sum(bin(int(x) & int(y)).count("1") for x, y in zip(a[m], b[n]))
                      for n in range(8)] for m in range(16)])
    a_t = torch.as_tensor(a.view(np.int32), device=dev)
    b_t = torch.as_tensor(b.view(np.int32), device=dev)
    d = torch.zeros(16, 8, dtype=torch.int32, device=dev)
    _call(lib, "ccm_mma_b1_tile", dev, a_t.data_ptr(), b_t.data_ptr(), d.data_ptr())
    torch.cuda.synchronize(dev)
    return bool(np.array_equal(d.cpu().numpy(), want))


def measure(dev) -> dict:
    """The tile check and the rate of independent 1-bit instructions over
    8 blocks of 8 warps per SM, timed with CUDA events."""
    lib = _load()
    tile_ok = check_tile(lib, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, chains = 8 * sms, lib.ccm_mma_b1_chains()
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)

    def run(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _call(lib, "ccm_mma_b1_loop", dev, blocks, iters, out.data_ptr())
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)

    run(16)
    iters = 64
    ms = run(iters)
    iters = max(iters, int(iters * TARGET_MS / max(ms, 1e-3)))
    ms = run(iters)
    n_mma = blocks * 8 * iters * chains
    mma_per_s = n_mma / (ms * 1e-3)
    clock = sm_clock_mhz() * 1e6
    return dict(tile_ok=tile_ok, mma_per_s=mma_per_s, pairs_per_s=mma_per_s * PAIRS_PER_MMA,
                mma_per_clk_per_sm=mma_per_s / (sms * clock), sms=sms,
                max_sm_clock_mhz=clock / 1e6, instructions=n_mma, ms=ms)


def main() -> int:
    if not torch.cuda.is_available():
        print("mma_b1_rate: no CUDA device available", file=sys.stderr)
        return 2
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    res = measure(dev)
    for line in finish_build(None).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[mma_b1_rate] {line.strip()}", flush=True)
    print(json.dumps(dict(card=smi, **res)), flush=True)
    return 0 if res["tile_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
