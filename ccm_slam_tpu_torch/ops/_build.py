"""Build the package's CUDA sources on first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``build/ccm_slam_tpu_torch/<name>-<hash>.so`` at the repository root,
keyed on a hash of the source and the flags, so an edited source is rebuilt
and an unchanged one is reused.  The ``-Xptxas -v`` register and spill
summary is kept beside the library (``.log``) and returned by ``build_log``.

Every library exports ``int`` C functions that return a CUDA error code
(0 on success; the stream is the last argument) and ``ccm_error_string``.
``load`` binds them, ``launch`` calls one on PyTorch's current stream and
raises on a non-zero code, and ``check_tensor`` / ``on_card`` are the
wrappers' argument checks.

Only the card's machine can build: this module compiles nothing until a
kernel is first launched.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ccm_slam_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build_all(names) -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    ``nvcc`` per source, all started together; waits for every one and
    raises if any failed."""
    procs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists."""
    return build_all([name])[name]


def build_log(name: str) -> str:
    """The compiler's output (ptxas register/spill summary) of the build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.is_file() else ""


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load the library, cached per process, with
    ``signatures`` {C function: argument ctypes} bound (each returns int)."""
    if name not in _LOADED:
        lib = ctypes.CDLL(str(build(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.ccm_error_string.argtypes = [ctypes.c_int]
        lib.ccm_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return _LOADED[name]


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args) -> None:
    """Call ``fn(*args, stream)`` on ``device``'s current stream; raises when
    the launch reports a CUDA error."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} ({lib.ccm_error_string(rc).decode()})")


def on_card(device: torch.device) -> bool:
    """False for the CPU (plain version); True for CUDA; raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type == "cuda":
        return True
    raise ValueError(f"unsupported device {device}")


def check_tensor(name: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous tensor of this dtype, shape and device."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
