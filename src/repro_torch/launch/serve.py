"""Serving launcher: batched autoregressive decode with continuous batching.

The port's own copy of `repro.launch.serve`.  A request queue feeds
decode slots; finished sequences release their slot to the next request
(continuous batching); every slot shares the one-token `decode_step`,
replayed as one CUDA graph on the card (`GraphedDecodeStep`, the
counterpart of the reference's ``jax.jit``).
Optionally the weights are fake-quantized (AutoQuant).  It runs on the
card unless ``--device cpu`` is given:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --requests 6 --slots 2 --max-new 16

Every class `get_model` builds serves: the dense, MoE, VLM and RWKV6
decoders (the VLM text-only, as the reference serves it) and whisper's
encoder-decoder, whose decode state holds zeroed cross-attention K/V
that the batcher never fills (the reference's batcher runs no encoder;
ROADMAP, "Reference defects").

The batcher keeps the reference's two properties, which make a request's
tokens depend on the requests served before it in its slot: one decode
position (``state["length"]``) shared by every slot, advanced by every
step, and slots whose caches are not cleared on admission.  So a request
admitted at step t attends to positions 0..t-1 of its slot, which hold
the previous occupant's K/V or zeros, and an RWKV6 request starts from
the WKV state and carried tokens its slot's last occupant left (ROADMAP,
"Reference defects").
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model


class Request:
    def __init__(self, rid: int, prompt: List[int], max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


class GraphedDecodeStep:
    """`decode_step` captured once as a CUDA graph and replayed: the
    card's counterpart of the reference's ``jax.jit(decode_step)``.  The
    same operations on the same tensors give the same values; the host
    launches one graph a step instead of some four thousand kernels.

    The first call captures the step for its parameters and its state's
    shapes; a later call with other parameters raises `ValueError` (the
    graph reads the captured tensors).  Every call returns ``(logits,
    state)`` where both are the graph's own buffers: the state is
    advanced in place, and the logits are overwritten by the next call.
    A state other than the returned one is copied in first."""

    def __init__(self, decode_step):
        self.decode_step = decode_step
        self.graph = None

    def _run(self, params):
        logits, new = self.decode_step(params, self.token, self.state)
        for k, v in new.items():
            # a tensor the step passes through (whisper's cross K/V) is
            # not copied onto itself
            if v is not self.state[k]:
                self.state[k].copy_(v)
        return logits

    def _capture(self, params, token, state) -> None:
        self.params = params
        self.token = token.clone()
        self.state = {k: v.clone() for k, v in state.items()}
        # warm up on a side stream (cuBLAS's workspace, the allocator),
        # then put the state back: capturing does not run the step
        side = torch.cuda.Stream(device=token.device)
        side.wait_stream(torch.cuda.current_stream(token.device))
        with torch.cuda.stream(side):
            self._run(params)
        torch.cuda.current_stream(token.device).wait_stream(side)
        for k, v in state.items():
            self.state[k].copy_(v)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = self._run(params)

    def __call__(self, params, token, state):
        if self.graph is None:
            self._capture(params, token, state)
        else:
            if params is not self.params:
                raise ValueError("GraphedDecodeStep: the graph was captured "
                                 "for other parameters")
            if state is not self.state:
                for k, v in state.items():
                    self.state[k].copy_(v)
            self.token.copy_(token)
        self.graph.replay()
        return self.logits, self.state


class ContinuousBatcher:
    """Slot-based continuous batching over a shared decode state, on the
    device that holds `params`: on the card through one CUDA graph of the
    decode step (`GraphedDecodeStep`), on the CPU the plain step."""

    def __init__(self, bundle, params, n_slots: int, max_len: int):
        self.bundle = bundle
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = params["embed"].device
        self.state = bundle.init_decode_state(n_slots, max_len,
                                              device=self.device)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.slot_remaining = np.zeros(n_slots, dtype=np.int64)
        self.next_tok = np.zeros(n_slots, dtype=np.int32)
        self._step = (GraphedDecodeStep(bundle.decode_step)
                      if self.device.type == "cuda" else bundle.decode_step)

    def admit(self, req: Request) -> bool:
        for s in range(self.n_slots):
            if self.slot_req[s] is None:
                self.slot_req[s] = req
                # prefill-by-decode: feed prompt tokens one at a time (the
                # slot-local fallback that shares the decode state layout)
                self.next_tok[s] = req.prompt[0]
                self.slot_remaining[s] = len(req.prompt) - 1 + req.max_new
                return True
        return False

    def active(self) -> bool:
        return any(r is not None for r in self.slot_req)

    def step(self):
        tokens = torch.from_numpy(self.next_tok.copy()).to(self.device)
        logits, self.state = self._step(self.params, tokens, self.state)
        sampled = logits.argmax(-1).to(torch.int32).cpu().numpy()
        for s, req in enumerate(self.slot_req):
            if req is None:
                continue
            consumed = len(req.prompt) - 1 + req.max_new - self.slot_remaining[s]
            if consumed + 1 < len(req.prompt):
                self.next_tok[s] = req.prompt[consumed + 1]   # still prefilling
            else:
                req.generated.append(int(sampled[s]))
                self.next_tok[s] = sampled[s]
            self.slot_remaining[s] -= 1
            if self.slot_remaining[s] <= 0:
                req.done = True
                self.slot_req[s] = None


def serve_requests(batcher: ContinuousBatcher, requests: List[Request]
                   ) -> int:
    """Admit and step until every request is done; the decode steps."""
    pending = list(requests)
    steps = 0
    while pending or batcher.active():
        while pending and batcher.admit(pending[0]):
            pending.pop(0)
        batcher.step()
        steps += 1
    return steps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--quant-bits", type=int, default=0,
                    help="0 = bf16 weights; 8/4 = AutoQuant fake-quant store")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to ask "
                         "for the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    bundle = get_model(cfg)
    rng = np.random.default_rng(0)

    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    if args.quant_bits:
        from repro_torch.quant.autoquant import fake_quant_params
        from repro_torch.quant.calibrate import REVERSE_TOPO_CLASSES
        params = fake_quant_params(
            params, {c: args.quant_bits for c in REVERSE_TOPO_CLASSES})
        print(f"serving with {args.quant_bits}-bit weights")

    batcher = ContinuousBatcher(bundle, params, args.slots, args.max_len)
    requests = [Request(i, list(rng.integers(0, cfg.vocab_size, size=4)),
                        args.max_new) for i in range(args.requests)]
    t0 = time.time()
    steps = serve_requests(batcher, requests)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    assert all(r.done for r in requests)
    n_toks = sum(len(r.generated) for r in requests)
    print(f"served {args.requests} requests ({n_toks} tokens) in "
          f"{steps} decode steps, {dt:.1f}s ({steps / max(dt, 1e-9):.1f} "
          f"steps/s) on {dev}")
    return steps


if __name__ == "__main__":
    main()
