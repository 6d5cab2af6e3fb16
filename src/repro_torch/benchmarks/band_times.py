"""Device time of the band kernel's whole-grid launches at the serving
shape.

    python -m repro_torch.benchmarks.band_times [--reps 20]

For each of the six benchmarks at 4x1080x1920 (design
`pipelines/types/<name>_b4.json`), one `fused_pipeline` launch per rate
island over the whole band grid, timed as `chip_smoke.py`'s phase 2
times it: warm (mean of `--reps` back-to-back calls, CUDA events) and
with the L2 flushed (mean of `--reps` calls each after writing 1 GiB).
Prints one JSON line ``{"card": ..., "times": {name: {"ms", "cold_ms"}}}``.

It calls only what every slice of the port has had since the band
kernel's first redesign (`encode_program`, `partition_islands`,
`island_program`, `ingest_input`, `fused_pipeline(enc, grid, batch)`),
so the same file times another checkout's `repro_torch` put first on
`PYTHONPATH` (``python path/to/band_times.py``), which builds its own
kernel from its own sources; run such checkouts in alternation in one
call on the same card to compare them.
"""
from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.stencil import kernel as K
from repro_torch.lowering import backends as B
from repro_torch.lowering import lower, partition_islands
from repro_torch.lowering.cuda_backend import island_program
from repro_torch.pipelines import ALL, usm
from repro_torch.pipelines.types import load_types

SHAPE = (4, 1080, 1920)
PARAMS = {"usm": dict(usm.DEFAULT_PARAMS)}


def _launcher(name: str, seed: int, dev: torch.device):
    """The pipeline's whole-grid island launches on seeded frames."""
    pipe = ALL[name]()
    lp = lower(pipe, load_types(name), params=PARAMS.get(name, {}))
    rng = np.random.default_rng(seed)
    bufs = {n: B.ingest_input(torch.from_numpy(
        rng.integers(0, 256, SHAPE).astype(np.float64)).to(dev),
        lp.stages[n]) for n in pipe.input_stages()}
    calls = []
    for isl in partition_islands(lp, SHAPE[1:]).islands:
        enc = K.encode_program(island_program(lp, isl))
        calls.append((K.fused_pipeline(enc, isl.schedule.grid, SHAPE[0]),
                      isl))

    def run():
        for f, isl in calls:
            bufs.update(zip(isl.outputs, f(*[bufs[n] for n in isl.inputs])))
    return run


def _warm_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _cold_ms(fn, reps: int, flush: torch.Tensor) -> float:
    fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.band_times")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("band_times: torch sees no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    times: Dict[str, Dict[str, float]] = {}
    for k, name in enumerate(ALL):
        run = _launcher(name, 20 + 2 * k, dev)
        times[name] = {"ms": _warm_ms(run, args.reps),
                       "cold_ms": _cold_ms(run, args.reps, flush)}
    print(json.dumps({"card": card, "shape": list(SHAPE),
                      "package": str(Path(K.__file__).parents[2]),
                      "times": times}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
