#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. print the card's name and power limit; build the band kernel
   (`src/repro_torch/kernels/stencil/csrc/fused_band.cu`) with nvcc;
2. hold the kernel against its plain PyTorch version on the card, island
   by island with `torch.equal`: usm, hcd and dus_ext at 1080x1920,
   batch 2, and dus_ext at 96x96 on a saturating phase plan; check a
   known answer (USM leaves a flat frame unchanged); time the kernel and
   the plain version at the serving shape;
3. serve 16 USM 1080x1920 frames through the port's `PipelineServer` at
   batch 4 on the kernel, with launch counts set to 0 just before, and
   check every result against the plain executor on the card; serve
   them once more under `torch.profiler` and print the device's busy
   share and where its time went (trace in `chiprun_out/`);
4. print a `{"kernels": [...]}` line, the card's name and power limit,
   and, last, `{"ok": true, "device": {...}}`.

Without a CUDA card it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
# the fastest non-tensor-core rate in the data sheet (float32); the
# kernel's f64 and int64 work runs no faster, so ops / this rate stays a
# lower bound on its time
PEAK_OPS_PER_S = 67e12
FRAME = (1080, 1920)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def frames(shape, seed):
    import numpy as np
    return np.random.default_rng(seed).integers(0, 256, shape).astype(
        np.float64)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back runs."""
    import torch
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


def islands(pipe, types, params, shape):
    """The lowered pipeline and its (island, encoded program) pairs."""
    from repro_torch.kernels.stencil.kernel import encode_program
    from repro_torch.lowering import lower, partition_islands
    from repro_torch.lowering.cuda_backend import island_program
    lp = lower(pipe, types, params=params)
    plan = partition_islands(lp, shape[-2:])
    return lp, [(isl, encode_program(island_program(lp, isl)))
                for isl in plan.islands]


def ingest(lp, img, dev):
    import torch
    from repro_torch.lowering import backends as B
    x = torch.from_numpy(img).to(dev)
    return {n: B.ingest_input(x, lp.stages[n])
            for n in lp.pipeline.input_stages()}


def check_islands(label, pipe, types, params, img, dev) -> float:
    """Kernel == plain version on every island; returns max |error|."""
    import torch
    from repro_torch.kernels.stencil import kernel as K
    lp, isls = islands(pipe, types, params, img.shape)
    buffers = ingest(lp, img, dev)
    err = 0.0
    for isl, enc in isls:
        ins = [buffers[n] for n in isl.inputs]
        got = K.fused_pipeline(enc, isl.schedule.grid, img.shape[0])(*ins)
        want = K.fused_pipeline_reference(enc, isl.schedule.grid,
                                          img.shape[0])(*ins)
        torch.cuda.synchronize()
        for n, g, w in zip(isl.outputs, got, want):
            assert g.device.type == dev.type and g.dtype == w.dtype \
                and g.shape == w.shape
            err = max(err, float((g.to(torch.float64)
                                  - w.to(torch.float64)).abs().max()))
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: kernel != plain version on "
                                     f"island {isl.idx} stage {n}")
        buffers.update(zip(isl.outputs, got))
    print(f"kernel == plain  {label}: {len(isls)} island(s), "
          f"{sum(i.schedule.grid for i, _ in isls)} band step(s), "
          f"max_abs_err {err}", flush=True)
    return err


def phase_design():
    """dus_ext's serving design plus per-residue bounds tighter than the
    true ranges, so per-residue saturation engages on random frames."""
    from repro_torch.core.fixedpoint import alpha_for_range
    from repro_torch.pipelines.types import load_types, types_from_data
    data = load_types("dus_ext").to_data()
    ranges = {"resS": ((2, 1), {"0,0": (-50, 50)}),
              "UyS": ((2, 1), {"0,0": (0, 150), "1,0": (0, 250)}),
              "band": ((2, 2), {"0,0": (-30, 30)})}
    data["phases"] = {
        s: {"lattice": list(lat),
            "ranges": {k: {"alpha": alpha_for_range(lo, hi),
                           "signed": lo < 0} for k, (lo, hi) in r.items()}}
        for s, (lat, r) in ranges.items()}
    return types_from_data(data)


def busy_ms(spans) -> float:
    """Length of the union of (start, end) intervals, in ms (us in)."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def trace_serving(pipe, types, params, imgs, card) -> None:
    """Serve `imgs` once more under `torch.profiler` and print, from its
    trace, the window's wall time, the device's busy and idle share in
    it, device time by kind (the band kernel, other kernels, copies to
    and from the host) and the submitting thread's host time.  The
    trace goes to `chiprun_out/serve_trace.json`."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.serve import PipelineServer
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "serve_trace.json"
    with PipelineServer(pipe, types, params, backend="cuda",
                        batch_size=4) as srv:
        srv.warmup([FRAME])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.serve"):
                futs = []
                for img in imgs:
                    with record_function("chip_smoke.submit"):
                        futs.append(srv.submit(img))
                for f in futs:
                    f.result(timeout=600)
                torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"]
    win, = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e["name"] == "chip_smoke.serve"
            and e.get("cat") == "user_annotation"]
    submit_ms = sum(e["dur"] for e in spans
                    if e["name"] == "chip_smoke.submit"
                    and e.get("cat") == "user_annotation") / 1e3
    kinds = {"fused_band": [], "other kernels": [], "H2D": [], "D2H": [],
             "other copies": []}
    for e in spans:
        cat, name = e.get("cat"), e["name"]
        a, b = max(e["ts"], win[0]), min(e["ts"] + e["dur"], win[1])
        if b <= a or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat == "kernel":
            kind = "fused_band" if "fused_band" in name else "other kernels"
        elif "HtoD" in name:
            kind = "H2D"
        elif "DtoH" in name:
            kind = "D2H"
        else:
            kind = "other copies"
        kinds[kind].append((a, b))
    wall = (win[1] - win[0]) / 1e3
    every = [s for v in kinds.values() for s in v]
    if not every:
        print(f"serving trace ({card}): the profiler recorded no device "
              f"events; device busy share not measured", flush=True)
        return
    busy = busy_ms(every)
    split = ", ".join(f"{k} {busy_ms(v):.3f} ms ({len(v)})"
                      for k, v in kinds.items())
    print(f"serving trace, {len(imgs)} usm {FRAME[0]}x{FRAME[1]} frames at "
          f"batch 4 under torch.profiler ({card}): window {wall:.3f} ms, "
          f"device busy {busy:.3f} ms ({100 * busy / wall:.2f}%), idle "
          f"{100 * (1 - busy / wall):.2f}%; device time by kind "
          f"(count): {split}; submitting thread in submit() "
          f"{submit_ms:.3f} ms", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels import _build
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.pipelines import ALL, usm
    from repro_torch.pipelines.types import load_types
    from repro_torch.serve import PipelineServer

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    paths = _build.build()
    print(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    # -- 2. kernel against its plain version ------------------------------
    params = {"usm": dict(usm.DEFAULT_PARAMS)}
    before = K.LAUNCHES["fused_band"]
    err = 0.0
    for k, name in enumerate(("usm", "hcd", "dus_ext")):
        err = max(err, check_islands(
            f"{name} 2x{FRAME[0]}x{FRAME[1]}", ALL[name](), load_types(name),
            params.get(name, {}), frames((2,) + FRAME, 10 + k), dev))
    err = max(err, check_islands("dus_ext 2x96x96 saturating phase plan",
                                 ALL["dus_ext"](), phase_design(), {},
                                 frames((2, 96, 96), 3), dev))
    assert K.LAUNCHES["fused_band"] > before, "the kernel never launched"

    flat = np.full((1,) + FRAME, 117.0)
    out = run_fixed(usm.build(), flat, load_types("usm"), params["usm"],
                    backend="cuda")["masked"]
    assert out.shape == (1,) + FRAME and torch.isfinite(out).all()
    assert torch.equal(out, torch.from_numpy(flat).to(dev)), \
        "USM changed a flat frame"
    print("known answer: USM leaves a flat 1080p frame unchanged", flush=True)

    # time one launch at the serving shape: usm, batch 4, 1080x1920
    lp, isls = islands(usm.build(), load_types("usm"), params["usm"],
                       (4,) + FRAME)
    (isl, enc), = isls
    bufs = ingest(lp, frames((4,) + FRAME, 1), dev)
    ins = [bufs[n] for n in isl.inputs]
    kern = K.fused_pipeline(enc, isl.schedule.grid, 4)
    plain = K.fused_pipeline_reference(enc, isl.schedule.grid, 4)
    ms = cuda_ms(lambda: kern(*ins), 20)
    plain_ms = cuda_ms(lambda: plain(*ins), 2)
    rows = enc.rows()
    moved = sum(a.numel() * a.element_size() for a in ins) + sum(
        4 * d["H"] * d["W"] * K.CONTAINERS[d["code"]].itemsize
        for _, d in enc.slots("out_slot"))
    # operations this input needs: per output pixel of each stage, a
    # multiply and an add per integer tap, one op per arithmetic
    # instruction of an expression program
    ops = 0
    for d in rows:
        if d["kind"] == K.KIND_INTLINEAR:
            per = 2 * d["tap_count"]
        elif d["kind"] == K.KIND_EXPR:
            code = enc.prog[d["prog_begin"]:d["prog_begin"] + d["prog_len"]]
            per = int(sum(op not in (K.OP_REF, K.OP_CONST)
                          for op in code[:, 0]))
        else:
            continue
        ops += 4 * d["H"] * d["W"] * per
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    print(f"fused_band usm 4x{FRAME[0]}x{FRAME[1]} ({card}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {bound_ms:.4f} ms "
          f"({moved} B at {HBM_BYTES_PER_S:.3g} B/s; {ops} ops at "
          f"{PEAK_OPS_PER_S:.3g}/s = {ops_ms:.4f} ms), 1 launch per batch "
          f"of 4 = 0.25 launches per frame", flush=True)
    for k, name in enumerate(("hcd", "dus_ext")):
        lp2, isls2 = islands(ALL[name](), load_types(name), {},
                             (4,) + FRAME)
        bufs = ingest(lp2, frames((4,) + FRAME, 20 + k), dev)
        calls = [(K.fused_pipeline(e, i.schedule.grid, 4),
                  [bufs[n] for n in i.inputs]) for i, e in isls2]
        t = cuda_ms(lambda: [f(*a) for f, a in calls], 5)
        print(f"fused_band {name} 4x{FRAME[0]}x{FRAME[1]} ({card}): "
              f"kernel {t:.4f} ms for {len(calls)} island(s)", flush=True)

    # -- 3. serving: the main path ----------------------------------------
    n_frames = 16
    imgs = [frames(FRAME, 100 + i) for i in range(n_frames)]
    K.LAUNCHES["fused_band"] = 0
    lat = [0.0] * n_frames
    with PipelineServer(usm.build(), load_types("usm"), params["usm"],
                        backend="cuda", batch_size=4) as srv:
        srv.warmup([FRAME])
        t_start = time.perf_counter()
        futs = []
        for i, img in enumerate(imgs):
            t_sub = time.perf_counter()
            fut = srv.submit(img)
            fut.add_done_callback(
                lambda f, i=i, t_sub=t_sub:
                lat.__setitem__(i, time.perf_counter() - t_sub))
            futs.append(fut)
        results = [f.result(timeout=600) for f in futs]
        t_end = time.perf_counter()
    launches = K.LAUNCHES["fused_band"]
    assert launches > 0, "serving never launched the kernel"
    assert srv.stats["frames"] == n_frames
    for b in range(0, n_frames, 4):
        want = run_fixed(usm.build(), np.stack(imgs[b:b + 4]),
                         load_types("usm"), params["usm"], backend="torch",
                         device=dev)["masked"].cpu()
        for j in range(4):
            got = results[b + j]["masked"]
            assert got.shape == FRAME and torch.isfinite(got).all()
            if not torch.equal(got, want[j]):
                raise AssertionError(f"served frame {b + j} != plain "
                                     f"executor")
    lat_ms = sorted(x * 1e3 for x in lat)
    p50 = float(np.percentile(lat_ms, 50))
    p99 = float(np.percentile(lat_ms, 99))
    fps = n_frames / (t_end - t_start)
    print(f"served {n_frames} usm {FRAME[0]}x{FRAME[1]} frames at batch 4 "
          f"({card}): {fps:.2f} frames/s, p50 {p50:.2f} ms, p99 "
          f"{p99:.2f} ms, {launches} kernel launches (warmup included), "
          f"batches {srv.stats['batches']}, pad frames "
          f"{srv.stats['padded']}, all equal to the plain executor",
          flush=True)

    # -- 3b. one traced serving pass: device busy share and its split -----
    trace_serving(usm.build(), load_types("usm"), params["usm"], imgs, card)

    # -- 4. result lines ---------------------------------------------------
    print(json.dumps({"kernels": [{
        "name": "fused_band", "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/fused_band.cu",
        "replaces": "src/repro/kernels/stencil/kernel.py:265",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
