"""Run one cell of the benchmark once: set-up, a measured window, a check
of what the window produced, and one JSON line.

Everything cell-specific is data found by name: the manifest
(``BENCHMARK.json``) names the cell's configuration and traffic; the
configuration's file holds the deployment's settings; the traffic's file
(``portbench/traffic/<traffic>.json``) names its kind of cell
(``portbench/cells/<kind>.py``), its sizes and its check limits; each
per-layer metric is a reader ``portbench/metrics/<metric>.py`` that says
which pass of a traced run it reads (``PASS``: "spans" or "profile") and,
for spans, which module function to time (``SPAN``).

A cell module has ``Cell(config, traffic, seed, device, program_root)``
with ``step()`` (one closed-loop item of work: returns 1),
``end_to_end(name, window_s, n)``, ``counters()``, ``reset_counters()``,
``check()`` -> (failed items, {name: (value, limit)}) and ``release()``;
``control(cell)``, which puts the cell's control in the timed path's place
once set-up is over; and ``FAULTS``, the faults that the calibration
(``calibrate.py``) plants under the timed path: name -> (module, function,
maker of the broken function).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time

import torch

from . import trace

BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "ccm_slam_tpu")


def load_manifest(root):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(manifest, root, workload):
    """(workload entry, config dict, traffic dict, end-to-end metric
    entries, per-layer metric entries) of a cell, found by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    with open(os.path.join(root, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "portbench", "traffic", f"{w['traffic']}.json")) as f:
        traffic = json.load(f)

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return (w, config, traffic, [m for m in manifest["end_to_end"] if mine(m)],
            [m for m in manifest["per_layer"] if mine(m)])


def load_reader(root, name):
    path = os.path.join(root, "portbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    return sorted({k.split(".")[0] for k in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _window(cell, dev, seconds):
    """(window seconds, items) of closed-loop steps until ``seconds`` pass."""
    _sync(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        n += cell.step()
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    return time.perf_counter() - t0, n


def run_cell(root, workload, seed, seconds, traced, dev, t0=None, manifest=None, prepare=None):
    """The result dict of one run (the contract's JSON line as a dict) and
    the compared numbers [(name, value, limit)].  ``prepare(cell)``, when
    given, runs after set-up (the calibration's control swaps the timed
    path there); the check always runs with TF32 off."""
    t0 = time.perf_counter() if t0 is None else t0
    manifest = manifest or load_manifest(root)
    w, config, traffic, e2e, per_layer = cell_spec(manifest, root, workload)
    kind = importlib.import_module(f"portbench.cells.{traffic['kind']}")
    if dev.type == "cuda":
        torch.empty(1, device=dev)  # the allocator exists before its counters are reset
        torch.cuda.reset_peak_memory_stats(dev)
    cell = kind.Cell(config, traffic, seed, dev, root)
    if prepare is not None:
        prepare(cell)
    out = dict(correct=False, attempted=0, failed=0, metrics={})
    info = {}
    if not traced:
        setup_s = time.perf_counter() - t0
        window_s, n = _window(cell, dev, seconds)
        out["attempted"] = n
        for m in e2e:
            value = setup_s if m["name"] == "setup_s" else cell.end_to_end(m["name"], window_s, n)
            out["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
    else:
        readers = {m["name"]: load_reader(root, m["name"]) for m in per_layer}
        ctx = dict(config=config, traffic=traffic)
        n = 0
        if any(r.PASS == "spans" for r in readers.values()):
            spans = trace.Spans(sync=dev.type == "cuda")
            for name, r in readers.items():
                if getattr(r, "SPAN", None):
                    spans.time(*r.SPAN, name)
            step_ms = []

            def synced_step():
                t1 = time.perf_counter()
                k = cell.step()
                _sync(dev)
                step_ms.append((time.perf_counter() - t1) * 1e3)
                return k

            holder = type("Synced", (), {"step": staticmethod(synced_step)})
            try:
                _, k = _window(holder, dev, seconds)
            finally:
                spans.restore()
            n += k
            ctx.update(spans=spans.ms, step_ms=step_ms)
        if any(r.PASS == "profile" for r in readers.values()):
            steps = int(traffic["trace_steps"])
            cell.reset_counters()
            _, summary = trace.profile(lambda: [cell.step() for _ in range(steps)], dev)
            n += steps
            ctx.update(profile=summary, profile_steps=steps, counters=cell.counters())
            info = dict(busy_s=summary["busy_s"], window_s=summary["window_s"])
            out["breakdown"] = dict(device_ops=summary["device_ops"],
                                    idle_gaps=summary["idle_gaps"])
        out["attempted"] = n
        for name, r in readers.items():
            value = r.read(ctx)
            if value is not None:
                out["metrics"][name] = dict(value=value, unit=r.UNIT)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out["device"] = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        count=int(w["chips"]), memory_peak_bytes=int(peak), **info)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed, checks = cell.check()
    out["failed"] = failed
    rows = [(k, float(v), float(lim)) for k, (v, lim) in checks.items()]
    out["correct"] = failed == 0 and all(v <= lim for _, v, lim in rows)
    out["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in rows}
    cell.release()
    return out, rows


def main(argv, t0):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.path.dirname(BENCH)
    manifest = load_manifest(root)
    chips = int({w["name"]: w for w in manifest["workloads"]}[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)  # one host thread: the program's host work is one dispatch loop
    out, rows = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t0=t0, manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, v, lim in rows:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
