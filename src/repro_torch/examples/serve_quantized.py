"""Serve a small model with batched requests + AutoQuant weights.

    PYTHONPATH=src python -m repro_torch.examples.serve_quantized [--device cpu]

The port's copy of `examples/serve_quantized.py`: runs the paper's
bit-width synthesis on an LM (AutoQuant), then serves batched requests
through the continuous batcher with the quantized weights, comparing
generated tokens against the bf16 server.  It runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.batches import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.serve import ContinuousBatcher, Request, serve_requests
from repro_torch.models.registry import get_model
from repro_torch.quant.autoquant import autoquant, fake_quant_params


def generate(bundle, params, prompts, max_new=8, slots=2, max_len=64):
    batcher = ContinuousBatcher(bundle, params, slots, max_len)
    reqs = [Request(i, p, max_new) for i, p in enumerate(prompts)]
    serve_requests(batcher, reqs)
    return [r.generated for r in reqs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_smoke_config("qwen3-4b")
    bundle = get_model(cfg)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=4)) for _ in range(4)]

    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))

    print("== AutoQuant: paper beta-search on LM weight classes ==")
    batches = [make_batch(cfg, 2, 16, seed=s, device=dev) for s in range(2)]
    res = autoquant(bundle, params, batches, target_agreement=0.97)
    print(f"   bits per class: {res.bits}")
    print(f"   token agreement: {res.quality:.3f} "
          f"({res.profile_passes} profile passes, "
          f"{res.bytes_ratio:.2f}x bf16 bytes)")

    qparams = fake_quant_params(params, res.bits)

    print("\n== serve 4 requests on both weight stores ==")
    ref = generate(bundle, params, prompts)
    quant = generate(bundle, qparams, prompts)
    agree = np.mean([a == b for ra, rq in zip(ref, quant)
                     for a, b in zip(ra, rq)])
    print(f"   generated-token agreement vs bf16 server: {agree:.2%}")
    for i, (a, b) in enumerate(zip(ref, quant)):
        print(f"   req{i}: bf16={a} int{max(res.bits.values())}={b}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
