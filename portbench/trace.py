"""What a traced run reads: a profiler window over the program, and wall
spans of named module functions.

``profile`` runs a callable under ``torch.profiler`` inside a
``record_function`` that marks the window, and reduces the trace to the
window's length, the union of the device's operation intervals in it (busy
time), the device operations by name, and the idle gaps between device
operations, each put down to the innermost host operation running at its
middle.  ``Patches`` replaces module functions by wrappers and puts them
back; ``Spans`` wraps module functions so that each call is timed by the
host clock with the device synchronised before and after (the syncs perturb
the timeline, so traced runs only).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

WINDOW = "portbench.window"
PROFILER_OWN = (WINDOW, "Activity Buffer Request")  # host events that are not the program's


def _short(name):
    """A device operation's function name without its return type, template
    arguments, parameters and all but the last namespace."""
    name = name.replace("(anonymous namespace)", "anon")
    if name.startswith("void "):
        name = name[5:]
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            cut = i
            break
    head, depth, out = name[:cut].strip(), 0, []
    for ch in head:  # drop template arguments
        depth += ch == "<"
        if depth == 0:
            out.append(ch)
        depth -= ch == ">"
    head = "".join(out).strip()
    if "::" not in head:
        return head[:60] or name[:60]
    return "::".join(head.split()[-1].split("::")[-2:])[:60]


def profile(fn, dev):
    """(fn's result, trace summary dict) of ``fn`` on ``dev``."""
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    card = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if card else [])
    if card:
        torch.cuda.synchronize(dev)
    with tprofile(activities=acts) as prof:
        with record_function(WINDOW):
            out = fn()
            if card:
                torch.cuda.synchronize(dev)
    return out, reduce_events(prof.events())


def reduce_events(events):
    """Summary of a profiler's FunctionEvents (see the module docstring)."""
    dev_kind = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW and e.device_type != dev_kind]
    if not win:
        raise RuntimeError("the profiler trace has no window marker")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev = [e for e in events if e.device_type == dev_kind and e.name != WINDOW
           and e.time_range.end > w0 and e.time_range.start < w1]
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) * 1e-6
    iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in dev)
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy_us = sum(t - s for s, t in merged)
    edges = [w0] + [x for st in merged for x in st] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    cpu = [e for e in events if e.device_type != dev_kind and e.name not in PROFILER_OWN]
    cs = np.array([e.time_range.start for e in cpu], np.float64)
    ce = np.array([e.time_range.end for e in cpu], np.float64)
    names = [e.name for e in cpu]
    by_host = {}
    for s, t in sorted(gaps, key=lambda g: g[0] - g[1])[:400]:
        mid = 0.5 * (s + t)
        inside = np.nonzero((cs <= mid) & (ce >= mid))[0]
        key = names[inside[np.argmin((ce - cs)[inside])]] if inside.size else "host python"
        by_host[key] = by_host.get(key, 0.0) + (t - s) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(
        window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6, device_ops_n=len(dev),
        time_by_kernel=_by_short(by_name),
        device_ops=[[_short(k), v] for k, v in top],
        idle_gaps=[[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:10]])


def _by_short(by_name):
    out = {}
    for k, v in by_name.items():
        out[_short(k)] = out.get(_short(k), 0.0) + v
    return out


class Patches:
    """Module functions replaced by wrappers: ``wrap(module, attr, make)``
    sets ``module.attr = make(original)``; ``restore`` puts the originals
    back, the last wrapped first."""

    def __init__(self):
        self._undo = []

    def wrap(self, module, attr, make):
        owner = importlib.import_module(module) if isinstance(module, str) else module
        fn = getattr(owner, attr)
        setattr(owner, attr, make(fn))
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo = []


def recorded(record):
    """A ``Patches.wrap`` maker: the function, with ``record(args, kw, out)``
    called after each call."""
    def make(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            record(args, kw, out)
            return out
        return call
    return make


class Spans(Patches):
    """Host-clock ms of each call of wrapped module functions, the device
    synchronised before and after; ``restore`` puts the originals back."""

    def __init__(self, sync=True):
        super().__init__()
        self.ms, self.sync = {}, sync

    def time(self, module, attr, name):
        def make(fn):
            def timed(*args, **kw):
                if self.sync:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args, **kw)
                if self.sync:
                    torch.cuda.synchronize()
                self.ms.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
                return out
            return timed
        self.wrap(module, attr, make)
