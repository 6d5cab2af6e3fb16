"""Per-call time of the band-kernel executor, tracing off.

    python -m repro_torch.benchmarks.executor_overhead [--calls 200]

Times `run_fixed(..., backend="cuda")` on batches that already lie on the
card: USM (`usm_b4.json`) on 4x1080x1920 frames and optical flow (`of`)
on 4 frame pairs of 1080x1920.  No copy crosses PCIe, so a call is its
host work (executor lookup, the span entries and the telemetry test of
`lowering/cuda_backend.py`'s `run`), the ingest, the band kernel and
the dequantization.  Each call is synchronized; the script prints the
median and quartiles in ms a call, and the card's name and power limit.

It calls nothing but `run_fixed`, whose signature predates the spans,
so the same file times another checkout's `repro_torch` put first on
`PYTHONPATH` (`python path/to/executor_overhead.py`); run such
checkouts in alternation on the same card to compare them.
"""
from __future__ import annotations

import argparse
import subprocess
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.dsl.exec import run_fixed
from repro_torch.pipelines import ALL, usm
from repro_torch.pipelines.types import load_types

FRAME = (4, 1080, 1920)


def _frames(seed: int) -> torch.Tensor:
    x = np.random.default_rng(seed).integers(0, 256, FRAME)
    return torch.from_numpy(x.astype(np.float64)).to("cuda")


def time_calls(call, n: int) -> List[float]:
    """ms of each of `n` synchronized calls, after two warm-up calls."""
    for _ in range(2):
        call()
    torch.cuda.synchronize()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.executor_overhead")
    ap.add_argument("--calls", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("executor_overhead: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    img = _frames(0)
    pair = (_frames(1), _frames(2))
    u, u_types, p = usm.build(), load_types("usm"), dict(usm.DEFAULT_PARAMS)
    of, of_types = ALL["of"](), load_types("of")
    cases = {
        "usm": lambda: run_fixed(u, img, u_types, p, device="cuda"),
        "of": lambda: run_fixed(of, pair, of_types, device="cuda"),
    }
    for name, call in cases.items():
        q1, med, q3 = np.percentile(time_calls(call, args.calls),
                                    [25, 50, 75])
        print(f"executor {name} {FRAME[0]}x{FRAME[1]}x{FRAME[2]} on the "
              f"card, {args.calls} calls: median {med:.4f} ms, quartiles "
              f"{q1:.4f} / {q3:.4f} ms ({card})", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
