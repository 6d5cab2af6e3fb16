"""Batched pipeline serving over the port's executor.

Port of `repro.serve.pipeline_server`.  Requests enter a queue; a
background thread packs them into fixed-size batches (zero-padded, so
one batched program per (batch, H, W) is ever built) and runs each batch
through one memoized executor (`dsl.exec.lowered_executor`).

Each frame is quantized once at submit, on the host, into its input
stage's legalized container (a frame already in that dtype is taken as
it is).  A batch is stacked into pinned host memory and copied to the
card without blocking; the executor ingests the container tensor
zero-copy.  Results come back to the host as f64 tensors, one dict per
frame.  `close()` drains: every queued request is served (the final
partial batch padded), then the worker stops; `submit` after close
raises.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dsl import exec as _exec
from repro_torch.lowering import backends as B

__all__ = ["PipelineServer", "serve_offline"]

_SENTINEL = object()
_MAX_QUEUE = 4096      # requests held before submit() blocks


class _Request:
    __slots__ = ("images", "future")

    def __init__(self, images: List[torch.Tensor]):
        self.images = images
        self.future: Future = Future()


class PipelineServer:
    """Batched serving front end over one compiled executor.

    ``backend`` is a port `run_fixed` backend (``"cuda"``, ``"torch"``,
    ``"lowered"``, ``"interp"`` or ``"sharded"``, the last over every
    card present); ``column`` and ``datapath`` are `run_fixed`'s.  A pipeline with several inputs (optical flow) takes
    each request as a tuple or a dict of frames.  ``batch_timeout_s``
    bounds how long a partial batch waits for more requests.  `stats`
    counts frames, batches and pad frames.  Usable as a context manager;
    `close()` drains."""

    def __init__(self, pipeline, types, params: Optional[dict] = None,
                 *, backend: str = "cuda", batch_size: int = 4,
                 column: Optional[str] = None, datapath: str = "exact",
                 batch_timeout_s: float = 0.002,
                 device: DeviceLike = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.pipeline = pipeline
        self.batch_size = int(batch_size)
        self.batch_timeout_s = float(batch_timeout_s)
        self.backend = backend
        self.device = resolve_device(device)
        self._executor = _exec.lowered_executor(
            pipeline, types, dict(params or {}), backend, self.device,
            column, datapath)
        self._input_names = pipeline.input_stages()
        lp = self._executor.lowered
        self._ingest = [lp.stages[n] for n in self._input_names]
        self.stats = {"frames": 0, "batches": 0, "padded": 0}
        self._q: "queue.Queue" = queue.Queue(maxsize=_MAX_QUEUE)
        self._closed = False
        self._warm: set = set()
        self._worker = threading.Thread(
            target=self._loop, name=f"serve-{pipeline.name}", daemon=True)
        self._worker.start()

    # -- request side -----------------------------------------------------

    def _quantize(self, a, slot: int) -> torch.Tensor:
        """Frame -> container tile on the host: as it is when already in
        the container dtype, one snap otherwise."""
        ls = self._ingest[slot]
        x = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.asarray(a))
        return B.ingest_input(x.cpu(), ls)

    def _normalize(self, image) -> List[torch.Tensor]:
        if isinstance(image, dict):
            arrs = [image[n] for n in self._input_names]
        elif isinstance(image, (tuple, list)):
            arrs = list(image)
        else:
            arrs = [image]
        if len(arrs) != len(self._input_names):
            raise ValueError(
                f"pipeline {self.pipeline.name!r} takes "
                f"{len(self._input_names)} inputs, got {len(arrs)}")
        for a in arrs:
            if a.ndim != 2:
                raise ValueError(
                    f"submit() takes single (H, W) frames; got "
                    f"{tuple(a.shape)}")
        return [self._quantize(a, i) for i, a in enumerate(arrs)]

    def submit(self, image) -> Future:
        """Enqueue one frame (array / tuple / dict of (H, W) arrays);
        resolves to ``{output: (H', W') f64 tensor on the host}``."""
        if self._closed:
            raise RuntimeError("PipelineServer is closed")
        req = _Request(self._normalize(image))
        self._q.put(req)
        return req.future

    def warmup(self, shapes: Iterable[Tuple[int, int]]) -> List[tuple]:
        """Build the batched program for each (H, W) ahead of traffic by
        running one zero batch in the input containers; returns the
        warmed (batch, H, W) keys."""
        warmed = []
        for h, w in shapes:
            key = (self.batch_size, int(h), int(w))
            if key in self._warm:
                continue
            zeros = [torch.zeros(key, dtype=B.store_dtype(ls))
                     for ls in self._ingest]
            self._run(zeros)
            self._warm.add(key)
            warmed.append(key)
        return warmed

    # -- batcher side -----------------------------------------------------

    def _run(self, frames: List[torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One (B, H, W) batch per input -> host f64 outputs."""
        batch = {}
        for name, x in zip(self._input_names, frames):
            if self.device.type == "cuda":
                x = x.pin_memory().to(self.device, non_blocking=True)
            batch[name] = x
        out = self._executor(batch)
        return {k: v.cpu() for k, v in out.items()}

    def _collect(self) -> Tuple[List[_Request], bool]:
        """Block for one request, then fill the batch until the timeout
        or the close sentinel.  Returns (requests, saw_sentinel)."""
        item = self._q.get()
        if item is _SENTINEL:
            return [], True
        reqs = [item]
        deadline = time.monotonic() + self.batch_timeout_s
        while len(reqs) < self.batch_size:
            try:
                nxt = self._q.get(timeout=max(deadline - time.monotonic(),
                                              0.0))
            except queue.Empty:
                break
            if nxt is _SENTINEL:
                return reqs, True
            reqs.append(nxt)
        return reqs, False

    def _serve_batch(self, reqs: List[_Request]) -> None:
        n = len(reqs)
        pad = self.batch_size - n
        try:
            frames = []
            for slot in range(len(self._input_names)):
                f = [r.images[slot] for r in reqs]
                f += [torch.zeros_like(f[0])] * pad
                frames.append(torch.stack(f))
            out = self._run(frames)
            self._warm.add((self.batch_size,) + tuple(frames[0].shape[1:]))
        except Exception as e:           # deliver, keep the loop alive
            for r in reqs:
                r.future.set_exception(e)
            return
        self.stats["frames"] += n
        self.stats["batches"] += 1
        self.stats["padded"] += pad
        for b, r in enumerate(reqs):
            r.future.set_result({k: v[b] for k, v in out.items()})

    def _loop(self) -> None:
        while True:
            reqs, stop = self._collect()
            if reqs:
                self._serve_batch(reqs)
            if stop:
                return

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        """Drain: serve everything queued (padding the final partial
        batch), then stop the worker."""
        if self._closed:
            return
        self._closed = True
        self._q.put(_SENTINEL)
        self._worker.join()

    def __enter__(self) -> "PipelineServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def serve_offline(server: PipelineServer, images: Sequence
                  ) -> List[Dict[str, torch.Tensor]]:
    """Submit every frame, gather the results in order."""
    futures = [server.submit(im) for im in images]
    return [f.result() for f in futures]
