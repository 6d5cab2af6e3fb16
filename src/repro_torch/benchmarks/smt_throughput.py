"""Boxes a second of the batched SMT engine on one workload.

    python -m repro_torch.benchmarks.smt_throughput [--device cuda] \\
        [--nodes 4096] [--trace-nodes 1024] [--no-counts]

The workload is the reference's solver-throughput smoke
(`benchmarks/run.py:_smt_throughput`): "can HCD's det exceed 2^30?",
`decide` with `BPBudget(nodes, 6)`, deadline-free, deep in unknown
territory so the whole node budget is searched.  After one warm-up
query (64 nodes), it prints one JSON line with:

* ``boxes_per_s``: nodes over the seconds of one `decide` call, ended by
  a synchronize on the card;
* on the card, unless ``--no-counts``: the host syncs a box (a second
  call under ``torch.cuda.set_sync_debug_mode("warn")``, one warning a
  synchronizing operation) and, from a third call of ``--trace-nodes``
  nodes under `torch.profiler`, the device's busy share of that call's
  wall time (the union of its kernels, copies and sets; also as a share
  of the same call's untraced wall time, as the profiler slows the
  host), device operations a box, and the walk kernels' launches a box
  where the checkout has them (`repro_torch.smt.walk.LAUNCHES`).

It calls only what the port's SMT engine has had since it was first
ported (`encode_stage`, `decide`, `BPBudget`), so the same file measures
another checkout's `repro_torch` put first on `PYTHONPATH`
(``python path/to/smt_throughput.py``); run two checkouts in turns in
one call on the same card to compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
import warnings
from typing import Dict, Optional

import torch

from repro_torch.core.range_analysis import analyze
from repro_torch.pipelines import hcd
from repro_torch.smt import solver as S
from repro_torch.smt.encoder import encode_stage

THRESHOLD = 2.0 ** 30


def workload():
    """(csp, root) of HCD's det, encoded as the reference's smoke does."""
    p = hcd.build()
    bounds = {n: r.range for n, r in analyze(p).items()}
    return encode_stage(p, "det", bounds)


def _decide(csp, root, nodes: int, dev):
    v = S.decide(csp, root, "ge", THRESHOLD, S.BPBudget(nodes, 6),
                 device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return v


def _walk_launches() -> Optional[Dict[str, int]]:
    try:
        from repro_torch.smt import walk
    except ImportError:         # a checkout without the walk kernels
        return None
    return walk.LAUNCHES


def rate(csp, root, nodes: int, dev) -> dict:
    t0 = time.perf_counter()
    v = _decide(csp, root, nodes, dev)
    secs = time.perf_counter() - t0
    return {"status": v.status, "nodes": v.nodes, "s": secs,
            "boxes_per_s": v.nodes / secs}


def syncs(csp, root, nodes: int, dev) -> dict:
    """Host syncs of one call, from the sync debug mode's warnings."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            v = _decide(csp, root, nodes, dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in got)
    return {"syncs": n, "syncs_per_box": n / max(v.nodes, 1)}


def _union_us(spans) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def trace(csp, root, nodes: int, dev) -> dict:
    """One call of `nodes` nodes under `torch.profiler`: its wall time,
    the device's busy time and its share of that wall time, device
    operations (kernels, copies, sets) and walk-kernel launches a box.
    The profiler slows the host, so the busy time is also given as a
    share of the same call's wall time untraced (timed just before)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    untraced_s = rate(csp, root, nodes, dev)["s"]
    launches = _walk_launches()
    before = dict(launches) if launches is not None else None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        v = _decide(csp, root, nodes, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    dev_events = [e for e in prof.events() if e.device_type ==
                  DeviceType.CUDA]
    out = {"trace_nodes": v.nodes, "trace_wall_s": wall_us / 1e6,
           "untraced_s": untraced_s}
    if not dev_events:
        out["busy_share"] = None      # the profiler saw no device events
        return out
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in dev_events])
    kernels = [e for e in dev_events if "emcpy" not in e.name
               and "emset" not in e.name]
    by_name: Dict[str, float] = {}
    for e in dev_events:
        by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) + \
            (e.time_range.end - e.time_range.start) / 1e3
    out.update(busy_share=busy / wall_us, busy_s=busy / 1e6,
               busy_share_untraced=busy / 1e6 / untraced_s,
               device_ops=len(dev_events),
               device_ops_per_box=len(dev_events) / max(v.nodes, 1),
               kernels_per_box=len(kernels) / max(v.nodes, 1),
               top_ms=dict(sorted(by_name.items(),
                                  key=lambda kv: -kv[1])[:4]))
    if before is not None:
        out["walk_launches_per_box"] = {
            k: (launches[k] - before[k]) / max(v.nodes, 1) for k in launches}
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def measure(dev, nodes: int = 4096, trace_nodes: int = 1024,
            counts: bool = True) -> dict:
    dev = torch.device(dev)
    csp, root = workload()
    _decide(csp, root, 64, dev)                   # warm-up: builds, caches
    res = {"device": str(dev), **rate(csp, root, nodes, dev)}
    if dev.type == "cuda":
        res["card"] = card_line()
        if counts:
            res.update(syncs(csp, root, nodes, dev))
            res.update(trace(csp, root, trace_nodes, dev))
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--trace-nodes", type=int, default=1024)
    ap.add_argument("--no-counts", action="store_true")
    a = ap.parse_args(argv)
    print(json.dumps(measure(a.device, a.nodes, a.trace_nodes,
                             not a.no_counts)), flush=True)


if __name__ == "__main__":
    main()
