"""ctypes bindings for the package's C++ runtime pieces (``csrc/native_*.cpp``).

Counterpart of ``ccm_slam_tpu/native/__init__.py``:

* ``NativeImageLoader``: a threaded, prefetching grayscale PNG stream
  (``csrc/native_loader.cpp``, needs libpng's headers);
* ``NativeChannel``: a length-framed TCP transport for pickled message trees
  between host processes (``csrc/native_channel.cpp``, the C library only),
  the ROS-topic replacement; the reliability layer lives in
  ``runtime/communicator.py`` above it.

Each source is compiled by ``g++`` on first use into
``build/ccm_slam_tpu_torch/<name>-<hash>.so`` at the repository root, keyed on
a hash of the source and the flags (as ``ops/_build.py`` does for ``nvcc``).
The channel's framing and pickle protocol are the reference's, so the two
packages' channels talk to each other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pickle
import shutil
import subprocess

import numpy as np
import torch

from .ops._build import BUILD_DIR, CSRC

_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
_LIBS = {"native_channel": (), "native_loader": ("-lpng", "-lz", "-pthread")}
_LOADED: dict[str, ctypes.CDLL] = {}


def library_path(name: str):
    src = (CSRC / f"{name}.cpp").read_bytes()
    key = hashlib.sha256(src + " ".join(_FLAGS + _LIBS[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def _build(name: str):
    out = library_path(name)
    if out.is_file():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX or put g++ on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp"),
                           *_LIBS[name]], capture_output=True, text=True)
    if proc.returncode != 0:
        if name == "native_loader" and "png.h" in proc.stderr:
            raise RuntimeError("NativeImageLoader needs libpng's headers (png.h), which this "
                               "machine lacks; the sequences' frames() read PNGs with PIL")
        raise RuntimeError(f"{cxx} failed for {name}.cpp (rc {proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(name: str) -> ctypes.CDLL:
    if name in _LOADED:
        return _LOADED[name]
    lib = ctypes.CDLL(str(_build(name)))
    if name == "native_loader":
        lib.ccm_loader_create.restype = ctypes.c_void_p
        lib.ccm_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.ccm_loader_next.restype = ctypes.c_int
        lib.ccm_loader_next.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.ccm_loader_destroy.argtypes = [ctypes.c_void_p]
    else:
        lib.ccm_tcp_listen.restype = ctypes.c_int
        lib.ccm_tcp_accept.restype = ctypes.c_int
        lib.ccm_tcp_connect.restype = ctypes.c_int
        lib.ccm_tcp_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ccm_tcp_send_msg.restype = ctypes.c_int
        lib.ccm_tcp_send_msg.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.ccm_tcp_recv_msg.restype = ctypes.c_int64
        lib.ccm_tcp_recv_msg.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
    _LOADED[name] = lib
    return lib


class NativeImageLoader:
    """Prefetching grayscale PNG stream: ``for img in loader:`` yields float32
    [H, W] arrays in path order while worker threads decode ahead."""

    def __init__(self, paths, n_threads: int = 4, queue_depth: int = 8,
                 max_h: int = 1024, max_w: int = 2048):
        self._h = None
        lib = _load("native_loader")
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._h = lib.ccm_loader_create(arr, len(self._paths), n_threads, queue_depth)
        self._lib = lib
        self._buf = np.zeros((max_h, max_w), np.uint8)
        self._max = (max_h, max_w)

    def __iter__(self):
        return self

    def __next__(self):
        oh, ow = ctypes.c_int(), ctypes.c_int()
        r = self._lib.ccm_loader_next(
            self._h,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.byref(oh), ctypes.byref(ow), self._max[0], self._max[1],
        )
        if r == 0:
            raise StopIteration
        if r < 0:
            raise IOError("native PNG decode failed")
        return self._buf[: oh.value, : ow.value].astype(np.float32)

    def close(self):
        if self._h:
            self._lib.ccm_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _host_tree(obj):
    """The message tree with every tensor leaf (on any device) a numpy array
    and every other leaf ``np.asarray``'d, as the reference's tree map does;
    ``bytes`` leaves (wire-packed payloads) and ``None`` pass through.
    Walks dicts, lists, tuples, NamedTuples and dataclasses."""
    if obj is None or isinstance(obj, bytes):
        return obj
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, dict):
        return {k: _host_tree(v) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_host_tree(v) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_tree(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _host_tree(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj) if f.init})
    return np.asarray(obj)


def _to_bytes(obj) -> bytes:
    """Message tree -> bytes: host numpy leaves, pickled container."""
    return pickle.dumps(_host_tree(obj), protocol=pickle.HIGHEST_PROTOCOL)


def _from_bytes(data: bytes):
    return pickle.loads(data)


class NativeChannel:
    """One framed-TCP connection carrying message trees."""

    MAX_MSG = 256 * 1024 * 1024

    def __init__(self, fd: int):
        self._lib = _load("native_channel")
        self._fd = fd
        self._buf = np.zeros(self.MAX_MSG, np.uint8)

    @classmethod
    def connect(cls, host: str, port: int) -> "NativeChannel":
        fd = _load("native_channel").ccm_tcp_connect(host.encode(), port)
        if fd < 0:
            raise ConnectionError(f"connect {host}:{port} failed")
        return cls(fd)

    @classmethod
    def listener(cls, port: int) -> int:
        """A listening socket on the loopback interface's ``port``."""
        fd = _load("native_channel").ccm_tcp_listen(port)
        if fd < 0:
            raise OSError(f"listen on {port} failed")
        return fd

    @classmethod
    def accept(cls, listen_fd: int) -> "NativeChannel":
        fd = _load("native_channel").ccm_tcp_accept(listen_fd)
        if fd < 0:
            raise OSError("accept failed")
        return cls(fd)

    def send(self, obj) -> None:
        data = np.frombuffer(_to_bytes(obj), np.uint8)
        r = self._lib.ccm_tcp_send_msg(
            self._fd, data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data)
        )
        if r != 0:
            raise ConnectionError("send failed")

    def recv(self):
        n = self._lib.ccm_tcp_recv_msg(
            self._fd, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.MAX_MSG,
        )
        if n == -1:
            raise ConnectionError("recv failed / closed")
        if n == -2:
            raise ValueError("message exceeded MAX_MSG")
        return _from_bytes(self._buf[:n].tobytes())

    def close(self):
        self._lib.ccm_tcp_close(self._fd)
