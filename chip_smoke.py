#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. print the card's name and power limit; build the four kernel
   libraries (`fused_band.cu`, `stencil.cu`, `qmatmul.cu`, `qdq.cu` under
   `src/repro_torch/kernels/*/csrc/`), one nvcc each, in parallel;
2. hold the band kernel against its plain PyTorch version on the card,
   island by island with `torch.equal`: usm, hcd, dus_ext, of and
   of_pyramid (frame pairs) at 1080x1920, batch 2, dus_ext at 96x96 on
   a saturating phase plan, and the narrow lowerings
   (``datapath="narrow"``) of of, hcd and usm at 1080x1920, printing
   which stages ran in f32; check known answers (USM leaves a flat frame
   unchanged; two equal flat frames give zero optical flow); at the
   serving shape 4x1080x1920, print each island's column tiles, work
   items, shared memory, blocks per SM, registers and tile placement
   (failing if any tile is in global memory), and time usm, hcd,
   dus_ext, of and of_pyramid warm and with the L2 flushed beside their
   bounds (usm, hcd and dus_ext also with every tile in global memory
   and at column tile 128; of also in the narrow lowering), and the
   plain version on usm and of;
2b. the kernel library: hold each of its five kernels against its plain
   version with `torch.equal` and time both at the sizes users run: one
   1080x1920 frame through a Sobel, a 5x5 blur and a 7x7 stencil of 9
   random taps (the generic loop), qwen3-4b's MLP up- and
   down-projection over 4096 tokens, and the block quantization of one
   of its weights in f32, bf16 and f16; beside the stencil, time a
   device-to-device copy of its input (the copy yardstick) and an empty
   launch, the kernel with the L2 flushed by reading too and back to
   back in a CUDA graph, and the whole `stencil_fixed` call with its
   launches (trace in `chiprun_out/`);
   beside `qmatmul_i32`, time
   `torch._int_mm` on b row-major and column-major and the kernel's
   pack pre-pass alone, and print the GEMM's tile, stages, shared bytes
   and registers; beside `block_dequantize`, time `q * s` (one PyTorch
   call); hold `block_quantize`, `block_dequantize` and
   `qmatmul_dequant` to their plain versions on rows and products below
   FLT_MIN (the flush rules), count the bf16 and f16 (scale, element)
   pairs whose reciprocal quotient differs from the exact division
   (none may), and time `block_quantize` in f32, bf16 and f16 with the
   L2 flushed by writing and by reading and back to back in a CUDA
   graph, in turns with a copy of the same bytes; then drive the
   library's front ends once with their launch counts set to 0 just
   before, and check what comes out;
3. serve 16 USM 1080x1920 frames through the port's `PipelineServer` at
   batch 4 on the kernel, with launch counts set to 0 just before, and
   check every result against the plain executor on the card; serve
   them once more under `torch.profiler` and print the device's busy
   share and where its time went (trace in `chiprun_out/`); then serve
   16 optical-flow frame pairs at 1080x1920, batch 4, the same way
   (counts from 0, every result against the plain executor);
5. analysis on the card: for each of the six benchmarks at 1080x1920,
   `run_plan` over interval, affine, intersect, a `ProfilePass` of 4
   seeded frames (frame pairs) on the card, refine(interval, profile)
   and cluster(interval), printing the seconds each pass took and the
   sum of alphas per column; check profile ⊆ interval ⊆
   cluster(interval) and that the interval column's design equals the
   committed `pipelines/types/<name>_b4.json`; run the profile and
   cluster designs through the kernel at 4x1080x1920 on fresh frames,
   each `torch.equal` to the plain version, with the band kernel's
   launches counted from 0 in one call; for `of`, time the profile's
   statistics on the card against the plain host version
   (`np_alpha_bits` on numpy copies);
6. the design search on the card: `run_design_search` on usm, hcd and
   dus_ext at 1080x1920 over 2 calibration images of the port's
   `pipelines.data.image_set`, from a plan of the interval column and a
   `ProfilePass` of those images on the card, scoring every candidate
   through the band kernel (``backend="cuda"``, 24 annealing steps,
   seed 0, every frontier point verified) under the budgets of
   `benchmarks/run.py:473` `_design_search` (50, 40, 45 dB); print
   seconds a search, evaluations a second, the frontier's size, the
   chosen design's power and area against the float design's, the host
   seconds spent building executors (lowering and encoding, one build a
   executor-cache miss), and, from a second, traced run of the same
   search (which must give the same result), the device's busy share
   and its time in the band kernel, reductions, other kernels and
   copies; check every frontier point verified and oracle-exact, one
   band-kernel launch per island per evaluated candidate and per
   verified point (counts from 0 just before the search), one launch
   per island for one fresh candidate, the chosen design within its
   budget and cheaper than the float design in power and area, and the
   same search at 32x32 on the card equal to the search through the
   oracle (``backend="interp"``) on the CPU in every field but the
   measured error;
7. the SMT range analysis on the card: for each of the six benchmarks
   at 1080x1920, `run_plan` over interval, the phase-5 `ProfilePass`
   (the same samples) and "smt" at the default `SMTConfig` (30 s a
   pipeline), its batched engine on the card (dus and dus_ext also
   "smt-phase-split"); print seconds and boxes a pass, the stages that
   kept their seed when the budget ran out and the sum of alphas a
   column, and check profile ⊆ smt ⊆ interval; run every SMT design
   (the phase-split ones through their residue types) through the band
   kernel at 4x1080x1920 on fresh frames, `torch.equal` to the plain
   version, with launches counted from 0 in one call; run `analyze_smt`
   deadline-free at the default node budgets on usm, dus and dus_ext on
   the card and on the CPU, printing seconds and boxes a second of each,
   and check every stage's range equal on both (a difference is printed
   with its stage and the first op of its CSP that differs, and fails
   the run); run the SMT column at the default budget on the host's CPU
   for hcd, of and of_pyramid (whose card runs reach the deadline) and
   print its seconds, boxes, seed-kept stages and sum of alphas beside
   the card's; print the phase's seconds;
8. workflows on the card: count how often the card's `pow` (for x ** n
   outside the band kernel) differs from numpy's, and check its `sqrt`
   and npops' min/max of +-0 against numpy's; (a) run the paper's
   Tables II-X, XII and Figures 5-6 through
   `repro_torch.benchmarks.paper_tables` at the reference's sizes on the
   card and on the host's CPU (the analysis memo cleared between), every
   row and derived line equal, printing each table's seconds on each;
   (b) the Figure 4 workflow at 1080x1920 on usm, hcd and dus (2 train
   and 2 test images; optical flow's beta search, over 20 s of host
   work, is left out to hold the script's time): static alphas, the
   profile on the card, the beta search through the band kernel (its
   launches counted from 0 after a warm-up evaluation), `design_report`,
   printing the sum of betas, the quality against the target,
   evaluations, seconds and launches, and the chosen design's outputs
   on one test image equal to the `"interp"` oracle on the card; (c)
   one USM batch of 4 at 1080x1920 served under
   `obs.enable(runtime_ranges=True)`, and the same batch through the
   band kernel with every stage asked for: outputs equal with telemetry
   off, `rt.range` records equal to the `"interp"` walk's on the host
   CPU per image (ranges joined, rail counts summed), headroom a stage,
   JSONL and Chrome trace in `chiprun_out/`, `obs.report`'s stage table;
   the phase's seconds;
9. print the seconds phases 1-8 took, a `{"kernels": [...]}` line, the
   card's name and power limit, and, last, `{"ok": true, "device":
   {...}}`.

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
# float64 outside the tensor cores (data sheet): the band kernel's f64
# expression ops run at this rate at best
F64_OPS_PER_S = 34e12
INT8_TC_OPS_PER_S = 1979e12    # int8 tensor cores, dense (data sheet)
FRAME = (1080, 1920)
# tokens x d_model x d_ff: qwen3-4b's MLP up-projection over 4096 tokens
# (src/repro/configs/qwen3_4b.py:11-12)
QWEN_UP = (4096, 2560, 9728)
# tokens x d_ff x d_model: its down-projection (K-long, fewer tiles)
QWEN_DOWN = (4096, 9728, 2560)
QDQ_BLOCK = 256
SOBEL = [[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]]
BLUR5 = [[a * b for b in (1, 4, 6, 4, 1)] for a in (1, 4, 6, 4, 1)]


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


N_IN = {"of": 2, "of_pyramid": 2}      # optical flow takes frame pairs


def inputs(name, shape, seed):
    """A pipeline's input: one frame, or a tuple of frames (seeds
    `seed`, `seed + 1`) for optical flow."""
    n = N_IN.get(name, 1)
    return frames(shape, seed) if n == 1 else tuple(
        frames(shape, seed + k) for k in range(n))


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


def cold_ms(fn, reps: int, flush, clean: bool = False) -> float:
    """Mean device time of `fn` over `reps` launches, each timed alone
    after writing `flush` evicted its inputs from the 50 MB L2.  `flush`
    is large (1 GiB, about 0.3 ms to write) so that the host has queued
    `fn`'s launches before the device reaches the start event: the time
    is the device's, not the wrapper's Python.  Writing leaves the L2
    full of dirty lines, which `fn` then writes back as it evicts them;
    `clean` reads `flush` instead (a sum), which leaves clean lines."""
    import torch
    fn()
    pairs = []
    for _ in range(reps):
        if clean:
            flush.sum(dtype=torch.int32)
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def graph_ms(fns, flush, reps: int = 5) -> float:
    """Device time per launch of `fns` (one launch each, on buffers of
    their own), captured once in a CUDA graph and replayed `reps` times
    after writing `flush`: launches back to back, as a pipeline issues
    them, without a timed launch's fixed cost or the host's pace.  One
    replay first, untimed, uploads the graph."""
    import torch
    for fn in fns:          # build and configure outside the capture
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in fns:
            fn()
    graph.replay()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps / len(fns)


def least_ms(moved: int, op_counts) -> tuple:
    """The bound: the larger of the bytes time and the operations time
    (each (count, peak rate) pair at its own rate), and which it is."""
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(n / rate for n, rate in op_counts) * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def same(label, got, want) -> float:
    """Kernel == plain version (values, dtype, shape); max |error|."""
    import torch
    err = 0.0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        err = max(err, float((g.double() - w.double()).abs().max()))
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: kernel != plain version "
                                 f"(max_abs_err {err})")
    return err


def ptxas_lines(name: str, kernel: str) -> list:
    """`-Xptxas -v`'s registers and spill lines of library `name`'s
    entry functions whose names contain `kernel`."""
    from repro_torch.kernels import _build
    log = _build.library_path(name).with_suffix(".log")
    lines, entry = [], ""
    for ln in log.read_text().splitlines() if log.exists() else []:
        if "Compiling entry function" in ln:
            entry = ln
        elif kernel in entry and ("registers" in ln or "spill" in ln):
            lines.append(ln.replace("ptxas info    :", "").strip())
    return lines


def stencil_extras(dev, card, flush, stencils, frame, t_in, t_out,
                   row) -> None:
    """Beside the stencil kernel's rows: the copy and empty-launch
    yardsticks, the kernel with the L2 flushed by reading, the kernel
    back to back in a CUDA graph, and the whole `stencil_fixed` call on
    a frame on the card, its device time, launches and the kernel's
    share of it.  Adds them to the result line's `row`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.kernels.stencil import ops as SO
    print(f"stencil.cu ptxas, generic and 8 templates ({card}): "
          f"{ptxas_lines('stencil', 'stencil_kernel')}", flush=True)
    # the copy yardstick: the same bytes as the bound, no stencil; and
    # the fixed cost of a timed launch (a 4-byte zero_)
    xq = stencils["sobel3x3"][0]
    dst = torch.empty_like(xq)
    tiny = torch.empty(1, dtype=torch.int32, device=dev)
    yard = {"copy": lambda: dst.copy_(xq), "empty launch": tiny.zero_}
    yard_ms = {}
    for name, fn in yard.items():
        yard_ms[name] = {"dirty": cold_ms(fn, 50, flush),
                         "clean": cold_ms(fn, 50, flush, clean=True)}
    row["copy_ms"] = yard_ms["copy"]["dirty"]
    row["yardsticks_ms"] = yard_ms
    print(f"stencil yardsticks ({card}): copy_ of the {xq.numel() * 4} B "
          f"padded frame into an int32 buffer, device to device, and an "
          f"empty launch; ms with the L2 flushed by writing (dirty) and "
          f"by reading (clean): {yard_ms}", flush=True)

    # the L2 flushed by reading, which leaves no dirty lines to write back
    clean = {label: cold_ms(lambda args=args: K.fixedpoint_stencil(*args),
                            50, flush, clean=True)
             for label, args in stencils.items()}
    row["clean_ms"] = clean
    print(f"stencil with the L2 flushed by reading ({card}), ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in clean.items()), flush=True)

    # back to back in a CUDA graph: 16 launches over 8 copies of each
    # input (66 MB, more than the L2), the copy yardstick the same way
    graph = {}
    for label, args in stencils.items():
        xs = [args[0].clone() for _ in range(8)]
        fns = {"kernel": [lambda x=x: K.fixedpoint_stencil(x, *args[1:])
                          for x in xs * 2]}
        if label == "sobel3x3":
            dsts = [torch.empty_like(x) for x in xs]
            fns["copy"] = [lambda x=x, d=d: d.copy_(x)
                           for x, d in zip(xs, dsts)] * 2
        graph[label] = {k: graph_ms(f, flush) for k, f in fns.items()}
        del xs, fns
        print(f"stencil {label} back to back in a CUDA graph ({card}), ms "
              f"a launch: " + ", ".join(f"{k} {v:.4f}"
                                        for k, v in graph[label].items()),
              flush=True)
    row["graph_ms"] = graph

    # the whole front end on a frame already on the card
    frame_dev = torch.from_numpy(frame).to(dev)
    call = lambda: SO.stencil_fixed(frame_dev, SOBEL, 1 / 12,  # noqa: E731
                                    t_in, t_out)
    call_ms = cold_ms(call, 20, flush)
    call()
    torch.cuda.synchronize()
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = out / "stencil_fixed_trace.json"
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    kinds = {}
    for e in events:
        name = ("stencil_kernel" if "stencil_kernel" in e["name"]
                else e["name"].split("<")[0][:60])
        kinds[name] = kinds.get(name, 0) + 1
    share = row["cases"][f"sobel3x3 {FRAME[0]}x{FRAME[1]}"]["ms"] / call_ms
    row["call_ms"] = call_ms
    row["call_launches"] = len(events)
    print(f"stencil_fixed sobel {FRAME[0]}x{FRAME[1]} f32 frame on the card "
          f"({card}): {call_ms:.4f} ms device time with the L2 flushed, "
          f"{len(events)} device launches (kernels, copies, sets): "
          f"{kinds}; the stencil kernel {100 * share:.1f}% of it",
          flush=True)


def subnormal_probes(dev, card) -> None:
    """Rows whose values or scales fall below FLT_MIN, in f32, bf16 and
    f16, through block_quantize and block_dequantize (a subnormal scale
    among the scales), and a 128^3 qmatmul_dequant whose products
    (f32(acc) * 1e-20) * 1e-19 fall below FLT_MIN for small |acc|: each
    kernel == its plain version (the CPU tests hold the plain versions
    to the JAX package's compiled code, which flushes these values)."""
    import torch
    from repro_torch.kernels.qdq import kernel as QD
    from repro_torch.kernels.qmatmul import kernel as QM
    tiny = torch.finfo(torch.float32).tiny
    g = torch.Generator(device=dev).manual_seed(19)
    rows = torch.randn((9, QDQ_BLOCK), device=dev, generator=g)
    for r, k in enumerate((1e-37, 1e-38, 1e-39)):
        rows[r] *= k
    rows[4] = torch.tensor([152.0, 0.9, -0.9, 0.5] * (QDQ_BLOCK // 4),
                           device=dev) * tiny
    rows[5, ::3] = 0.7 * tiny
    rows[6] *= 1e-36 / rows[6].abs().max()
    rows[7] *= 1e-5
    rows[8] = torch.tensor([127.0, -3.0, 0.6, -0.6] * (QDQ_BLOCK // 4),
                           device=dev) * tiny
    flushed = {}
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        x = rows.to(dt)
        q, s = QD.block_quantize(x)
        same(f"block_quantize subnormal probe {dt}", (q, s),
             QD.block_quantize_reference(x))
        s_sub = s.clone()
        s_sub[3] = -1e-39
        same(f"block_dequantize subnormal scale {dt}",
             (QD.block_dequantize(q, s_sub),),
             (QD.block_dequantize_reference(q, s_sub),))
        flushed[str(dt).split(".")[-1]] = int((s == 1.0).sum())
    a = torch.randint(-128, 128, (128, 128), dtype=torch.int8, device=dev,
                      generator=g)
    b = torch.randint(-128, 128, (128, 128), dtype=torch.int8, device=dev,
                      generator=g)
    sa = torch.full((128, 1), 1e-20, device=dev)
    sb = torch.full((1, 128), 1e-19, device=dev)
    got = QM.qmatmul_dequant(a, b, sa, sb)
    same("qmatmul_dequant subnormal products", (got,),
         (QM.qmatmul_dequant_reference(a, b, sa, sb),))
    # the proof of the bf16 and f16 rows' reciprocal quotient
    bad = {str(dt).split(".")[-1]: QD.quotient_mismatches(dt, dev)
           for dt in (torch.bfloat16, torch.float16)}
    assert not any(bad.values()), f"fast quotient != exact path: {bad}"
    print(f"block_quantize fast quotient ({card}): codes that differ from "
          f"the exact path's over every (scale, element) pair of a fast "
          f"row: {bad}", flush=True)
    print(f"subnormal probes ({card}): block_quantize and "
          f"block_dequantize == plain version in f32, bf16 and f16 (rows "
          f"with scale 1 by dtype: {flushed}); qmatmul_dequant 128^3 at "
          f"sa 1e-20, sb 1e-19 == plain version, {int((got != 0).sum())} "
          f"nonzero outputs of 16384", flush=True)


def qdq_extras(dev, card, flush, w, rows) -> None:
    """Beside the block_quantize rows: f32, bf16 and f16 timed three ways
    (the L2 flushed by writing and by reading, and back to back in a
    CUDA graph over 4 copies of the input), in turns with a
    device-to-device copy of the same bytes (the copy yardstick).  Adds
    them to `rows`."""
    import torch
    from repro_torch.kernels.qdq import kernel as QD
    print(f"qdq.cu ptxas ({card}): {ptxas_lines('qdq', 'quantize')}",
          flush=True)
    x32 = w.reshape(-1, QDQ_BLOCK)
    nb, n = x32.shape[0], x32.numel()
    three = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16"),
                    (torch.float16, "f16")):
        x = x32.to(dt)
        moved = x.element_size() * n + n + 4 * nb
        src8 = torch.empty(moved // 2, dtype=torch.uint8, device=dev)
        dst8 = torch.empty_like(src8)
        calls = {"kernel": lambda x=x: QD.block_quantize(x),
                 "copy": lambda: dst8.copy_(src8)}
        # in turns: two rounds of each, flushed by writing and by reading
        res = {k: {"dirty": 0.0, "clean": 0.0} for k in calls}
        for _ in range(2):
            for k, fn in calls.items():
                res[k]["dirty"] += cold_ms(fn, 25, flush) / 2
                res[k]["clean"] += cold_ms(fn, 25, flush, clean=True) / 2
        # back to back: 8 launches over 4 copies of the input (or of the
        # copy's source), more than the L2 holds together; in turns, two
        # rounds, the second in the reverse order
        xs = [x.clone() for _ in range(4)]
        srcs = [src8.clone() for _ in range(4)]
        dsts = [torch.empty_like(src8) for _ in range(4)]
        graphs = {"kernel": [lambda x=x_: QD.block_quantize(x) for x_ in xs],
                  "copy": [lambda a=a, b=b: b.copy_(a)
                           for a, b in zip(srcs, dsts)]}
        rounds = {k: [] for k in graphs}
        for order in (list(graphs), list(graphs)[::-1]):
            for k in order:
                rounds[k].append(graph_ms(graphs[k] * 2, flush))
        for k, v in rounds.items():
            res[k]["graph"] = sum(v) / len(v)
            res[k]["graph_rounds"] = v
        del xs, srcs, dsts, graphs, src8, dst8
        three[tag] = res
        print(f"block_quantize {nb}x{QDQ_BLOCK} {tag} ({card}): ms with the "
              f"L2 flushed by writing (dirty), by reading (clean) and back "
              f"to back in a CUDA graph (graph), beside a copy_ of "
              f"{moved // 2} B (the same {moved} B moved): "
              f"{json.dumps(res)}", flush=True)
    rows["block_quantize"]["three_ways"] = three


def kernel_library(dev, card):
    """Phase 2b (see the module docstring).  Returns the result line's
    rows of the five library kernels."""
    import numpy as np
    import torch

    from repro_torch.core.fixedpoint import FixedPointType
    from repro_torch.kernels.qdq import kernel as QD
    from repro_torch.kernels.qdq import ops as DO
    from repro_torch.kernels.qmatmul import kernel as QM
    from repro_torch.kernels.qmatmul import ops as QO
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.kernels.stencil import ops as SO

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev).manual_seed(13)
    rows = {}

    def measure(name, label, kern, plain, moved, ops, reps=(50, 10),
                library=None):
        """Compare, time and print one kernel; keep the row of the first
        `label` of each kernel for the result line."""
        err = same(f"{name} {label}", kern(), plain())
        torch.cuda.synchronize()
        ms = cold_ms(kern, reps[0], flush)
        plain_ms = cold_ms(plain, reps[1], flush)
        lib_ms = None if library is None else cold_ms(library, reps[0],
                                                      flush)
        bound_ms, bound_by = least_ms(moved, ops)
        print(f"{name} {label} ({card}): kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by}: {moved} B, "
              f"{sum(n for n, _ in ops)} ops), max_abs_err {err}",
              flush=True)
        rows.setdefault(name, {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms})
        rows[name].setdefault("cases", {})[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "library_ms": lib_ms}
        return ms

    # stencil: one 1080p frame, Sobel / 12 u8.0 -> s9.4 (the case of
    # benchmarks/run.py:44-46), a 5x5 binomial blur, and a 7x7 footprint
    # with 9 random taps, which no template takes (the generic loop)
    frame = frames(FRAME, 30).astype(np.float32)
    t_in, t_out = FixedPointType(8, 0, False), FixedPointType(9, 4, True)
    pixels = FRAME[0] * FRAME[1]
    g7 = np.random.default_rng(7)
    taps7 = [(-3, -3, 5)] + [
        (int(dy), int(dx), int(w)) for dy, dx, w in zip(
            g7.integers(-3, 4, 8), g7.integers(-3, 4, 8),
            g7.integers(-64, 65, 8))]
    stencils = {}
    for label, weights, scale in (("sobel3x3", SOBEL, 1 / 12),
                                  ("blur5x5", BLUR5, 1 / 256)):
        stencils[label] = SO.stencil_operands(frame, weights, scale, t_in,
                                              t_out, dev)
    stencils["generic7x7"] = (
        SO._edge_pad(SO.quantize_image(frame, t_in, dev), 3, 3), taps7,
        (3, 3), 5, t_out.int_min, t_out.int_max)
    for label, args in stencils.items():
        measure("stencil", f"{label} {FRAME[0]}x{FRAME[1]}",
                lambda: (K.fixedpoint_stencil(*args),),
                lambda: (K.fixedpoint_stencil_reference(*args),),
                args[0].numel() * 4 + pixels * 4,
                [(2 * len(args[1]) * pixels, PEAK_OPS_PER_S)])
    stencil_extras(dev, card, flush, stencils, frame, t_in, t_out,
                   rows["stencil"])

    # qmatmul: int8 codes of qwen3-4b's up- and down-projection over 4096
    # tokens; torch._int_mm is the yardstick only, timed here and called
    # nowhere in the port: on b as it is (row-major) and on a
    # column-major copy made outside the timed window (cuBLASLt's int8
    # layout)
    cfg = QM.gemm_config()
    print(f"qmatmul GEMM ({card}): {cfg}; ptxas, both GEMM kernels: "
          f"{ptxas_lines('qmatmul', 'qmm_kernel')}", flush=True)
    shapes = {}
    for M, Kd, N in (QWEN_UP, QWEN_DOWN):
        mm_label = f"{M}x{Kd}x{N}"
        a_q = torch.randint(-128, 128, (M, Kd), dtype=torch.int8,
                            device=dev, generator=gen)
        b_q = torch.randint(-128, 128, (Kd, N), dtype=torch.int8,
                            device=dev, generator=gen)
        # qmatmul_dequant: the product of f32 operands through
        # matmul_quantized's quantizers
        a = torch.randn((M, Kd), device=dev, generator=gen)
        b = torch.randn((Kd, N), device=dev, generator=gen)
        (qa, sa), (qb, sb) = QO.quantize_rows(a), QO.quantize_cols(b)
        deq = (qa, qb, sa, sb)
        b_cm = b_q.t().contiguous().t()
        acc_want = QM.qmatmul_i32_reference(a_q, b_q)
        deq_want = QM.qmatmul_dequant_reference(*deq)
        err = {"qmatmul_i32": same(f"qmatmul_i32 {mm_label}",
                                   (QM.qmatmul_i32(a_q, b_q),), (acc_want,)),
               "qmatmul_dequant": same(f"qmatmul_dequant {mm_label}",
                                       (QM.qmatmul_dequant(*deq),),
                                       (deq_want,))}
        # the split: the pack pre-pass alone
        same(f"pack_b {mm_label}", (QM.pack_b(b_q),),
             (QM.pack_b_reference(b_q),))
        timed = {
            "qmatmul_i32": lambda: QM.qmatmul_i32(a_q, b_q),
            "qmatmul_dequant": lambda: QM.qmatmul_dequant(*deq),
            "pack": lambda: QM.pack_b(b_q)}
        # torch._int_mm is the yardstick only, timed here and called
        # nowhere in the port: on b as it is (row-major) and on a
        # column-major copy made outside the timed window (cuBLASLt's
        # int8 layout)
        for layout, bb in (("row-major", b_q), ("column-major", b_cm)):
            fn = lambda bb=bb: torch._int_mm(a_q, bb)  # noqa: E731
            try:
                equal = torch.equal(fn(), acc_want)
            except RuntimeError as e:   # the yardstick only; no port path
                print(f"torch._int_mm refused b {layout} {mm_label}: {e}",
                      flush=True)
                continue
            print(f"torch._int_mm b {layout} {mm_label} == plain version: "
                  f"{equal}", flush=True)
            timed[f"int_mm {layout}"] = fn
        # the kernels and yardsticks in turns (two rounds of 10 launches
        # each, the L2 flushed before every launch), then the plain
        # versions, whose f64 products heat the card
        ms = {k: 0.0 for k in timed}
        for _ in range(2):
            for k, fn in timed.items():
                ms[k] += cold_ms(fn, 10, flush) / 2
        plain = {"qmatmul_i32": cold_ms(
                     lambda: QM.qmatmul_i32_reference(a_q, b_q), 3, flush),
                 "qmatmul_dequant": cold_ms(
                     lambda: QM.qmatmul_dequant_reference(*deq), 3, flush)}
        works = {"qmatmul_i32": (M * Kd + Kd * N + 4 * M * N,
                                 [(2 * M * N * Kd, INT8_TC_OPS_PER_S)]),
                 # the f32 epilogue: 2 multiplies an output, f32 rate
                 "qmatmul_dequant": (M * Kd + Kd * N + 4 * (M + N)
                                     + 4 * M * N,
                                     [(2 * M * N * Kd, INT8_TC_OPS_PER_S),
                                      (2 * M * N, PEAK_OPS_PER_S)])}
        for name, (moved, ops) in works.items():
            bound_ms, bound_by = least_ms(moved, ops)
            lib_ms = ms.get("int_mm row-major") if name == "qmatmul_i32" \
                else None
            print(f"{name} {mm_label} ({card}): kernel {ms[name]:.4f} ms, "
                  f"plain {plain[name]:.4f} ms, library {lib_ms} ms, bound "
                  f"{bound_ms:.4f} ms ({bound_by}: {moved} B, "
                  f"{sum(n for n, _ in ops)} ops), max_abs_err {err[name]}",
                  flush=True)
            rows.setdefault(name, {
                "max_abs_err": err[name], "ms": ms[name],
                "plain_ms": plain[name], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms})
        print(f"qmatmul {mm_label} ({card}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
        shapes[mm_label] = {k: v for k, v in ms.items()
                            if k not in works} | {
            f"{k}_ms": v for k, v in ms.items() if k in works}
        if (M, Kd, N) == QWEN_UP:
            up = (a_q, b_q, acc_want, a, b, deq, mm_label)
        del a_q, b_q, b_cm, acc_want, deq_want, a, b, qa, qb, sa, sb, deq
    a_q, b_q, acc_want, a, b, deq, mm_label = up
    for name in ("qmatmul_i32", "qmatmul_dequant"):
        rows[name]["shapes"] = shapes
        rows[name]["gemm"] = cfg
    rows["qmatmul_i32"]["library_colmajor_ms"] = \
        shapes[mm_label].get("int_mm column-major")

    # block_quantize / block_dequantize: one up-projection weight
    M, Kd, N = QWEN_UP
    w = torch.randn((Kd, N), device=dev, generator=gen) * 0.02
    x = w.reshape(-1, QDQ_BLOCK)
    nb, n = x.shape[0], x.numel()
    q, s = QD.block_quantize(x)
    qd_label = f"{nb}x{QDQ_BLOCK}"
    # per element: abs, max, divide, rint, 2 clamps; per row 1 multiply
    measure("block_quantize", qd_label, lambda: QD.block_quantize(x),
            lambda: QD.block_quantize_reference(x), 4 * n + n + 4 * nb,
            [(6 * n + nb, PEAK_OPS_PER_S)])
    # per element: convert, multiply; the library call is `q * s`, one
    # PyTorch call with int8 -> f32 promotion (timed here only)
    measure("block_dequantize", qd_label,
            lambda: (QD.block_dequantize(q, s),),
            lambda: (QD.block_dequantize_reference(q, s),),
            n + 4 * nb + 4 * n, [(2 * n, PEAK_OPS_PER_S)],
            library=lambda: q * s)
    assert torch.equal(q * s, QD.block_dequantize_reference(q, s))
    # the same weight in bf16 and f16: 2-byte loads, codes and scales as
    # for f32; dequantizing their codes writes f32, as for f32
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        xn = x.to(dt)
        qn, sn = QD.block_quantize(xn)
        measure("block_quantize", f"{qd_label} {tag}",
                lambda: QD.block_quantize(xn),
                lambda: QD.block_quantize_reference(xn), 2 * n + n + 4 * nb,
                [(6 * n + nb, PEAK_OPS_PER_S)])
        measure("block_dequantize", f"{qd_label} codes of {tag}",
                lambda: (QD.block_dequantize(qn, sn),),
                lambda: (QD.block_dequantize_reference(qn, sn),),
                n + 4 * nb + 4 * n, [(2 * n, PEAK_OPS_PER_S)],
                library=lambda: qn * sn)
    subnormal_probes(dev, card)
    qdq_extras(dev, card, flush, w, rows)
    w16 = w.to(torch.bfloat16)
    frame_u8 = frame.astype(np.uint8)
    t_in2 = FixedPointType(10, 2, False)

    # -- the library path through its front ends, counts from 0 --------
    counters = {"stencil": K.LAUNCHES, "qmatmul_i32": QM.LAUNCHES,
                "qmatmul_dequant": QM.LAUNCHES,
                "block_quantize": QD.LAUNCHES,
                "block_dequantize": QD.LAUNCHES}
    for name, c in counters.items():
        c[name] = 0
    t0 = time.perf_counter()
    sobel = SO.stencil_fixed(frame, SOBEL, 1 / 12, t_in, t_out)
    blur = SO.stencil_fixed(frame, BLUR5, 1 / 256, t_in, t_out)
    acc = QM.qmatmul_i32(a_q, b_q)
    y = QO.matmul_quantized(a, b)
    fq = DO.fake_quant(w)
    codes, scales, pad = DO.compress(w)
    back = DO.decompress(codes, scales, pad, w.shape)
    fq16 = DO.fake_quant(w16)
    sobel_u8 = SO.stencil_fixed(frame_u8, SOBEL, 1 / 12, t_in2, t_out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c[name] for name, c in counters.items()}
    missing = [name for name, k in launches.items() if k == 0]
    assert not missing, f"the library path never launched {missing}"

    # what came out: the stencils equal the front end on the CPU (the
    # plain version, held to the JAX package by the CPU tests)
    for label, out, weights, scale in (("sobel", sobel, SOBEL, 1 / 12),
                                       ("blur", blur, BLUR5, 1 / 256)):
        assert out.shape == FRAME and torch.isfinite(out).all()
        want = SO.stencil_fixed(frame, weights, scale, t_in, t_out,
                                device="cpu")
        assert torch.equal(out.cpu(), want), f"stencil_fixed {label}"
    assert torch.equal(acc, acc_want), "qmatmul_i32 on the library path"
    assert y.shape == (M, N) and torch.isfinite(y).all()
    assert torch.equal(y, QM.qmatmul_dequant_reference(*deq)), \
        "matmul_quantized != plain version"
    exact = a @ b
    rel = float((y - exact).norm() / exact.norm())
    small = [np.random.default_rng(i).normal(size=sh).astype(np.float32)
             for i, sh in ((1, (256, 512)), (2, (512, 384)))]
    assert torch.equal(QO.matmul_quantized(*small).cpu(),
                       QO.matmul_quantized(*small, device="cpu")), \
        "matmul_quantized: card != CPU on 256x512x384"
    # fake_quant's round trip: within s/2 of x per element, give or take
    # the f32 rounding of x / s and of q * s (|x| 2^-23 together)
    s_el = scales.expand(-1, QDQ_BLOCK).reshape(w.shape).double()
    slack = (fq.double() - w.double()).abs() - (
        s_el / 2 + w.double().abs() * 2.0 ** -23)
    assert fq.shape == w.shape and float(slack.max()) <= 0.0, \
        "fake_quant strays more than s/2"
    assert torch.equal(back, fq), "decompress(compress(w)) != fake_quant(w)"
    # bf16 through the front end: the plain versions' composition on the
    # card (held to the JAX package by the CPU tests)
    want16 = QD.block_dequantize_reference(*QD.block_quantize_reference(
        w16.reshape(-1, QDQ_BLOCK))).reshape(w.shape).to(torch.bfloat16)
    assert fq16.dtype == torch.bfloat16 and torch.equal(fq16, want16), \
        "fake_quant on bf16 != plain version"
    # an integer frame at beta_in 2 (it wraps in uint8, as the reference)
    assert torch.equal(sobel_u8.cpu(), SO.stencil_fixed(
        frame_u8, SOBEL, 1 / 12, t_in2, t_out, device="cpu")), \
        "stencil_fixed on a uint8 frame: card != CPU"
    print(f"library path ({card}): stencil_fixed sobel + blur + sobel "
          f"on uint8 at beta_in 2 {FRAME[0]}x{FRAME[1]}, qmatmul_i32 and "
          f"matmul_quantized {mm_label}, fake_quant (f32 and bf16) + "
          f"compress/decompress {qd_label} in "
          f"{wall * 1e3:.2f} ms (host clock); launches {launches}; "
          f"matmul_quantized relative error vs f32 matmul {rel:.3e}; "
          f"fake_quant within s/2; card == CPU on the stencils and a "
          f"256x512x384 matmul_quantized; bf16 fake_quant == plain "
          f"version", flush=True)

    sources = {"stencil": ("stencil/csrc/stencil.cu",
                           "stencil/kernel.py:89"),
               "qmatmul_i32": ("qmatmul/csrc/qmatmul.cu",
                               "qmatmul/kernel.py:56"),
               "qmatmul_dequant": ("qmatmul/csrc/qmatmul.cu",
                                   "qmatmul/kernel.py:76"),
               "block_quantize": ("qdq/csrc/qdq.cu", "qdq/kernel.py:30"),
               "block_dequantize": ("qdq/csrc/qdq.cu", "qdq/kernel.py:50")}
    return [{"name": name, "route": "cuda",
             "source": f"src/repro_torch/kernels/{src}",
             "replaces": f"src/repro/kernels/{rep}",
             "launches": launches[name], **rows[name]}
            for name, (src, rep) in sources.items()]


def islands(pipe, types, params, shape, datapath="exact"):
    """The lowered pipeline and its (island, encoded program) pairs."""
    from repro_torch.kernels.stencil.kernel import encode_program
    from repro_torch.lowering import lower, partition_islands
    from repro_torch.lowering.cuda_backend import island_program
    lp = lower(pipe, types, params=params, datapath=datapath)
    plan = partition_islands(lp, shape[-2:])
    return lp, [(isl, encode_program(island_program(lp, isl)))
                for isl in plan.islands]


def ingest(lp, img, dev):
    """Input stage -> its stored tile on `dev`; `img` is one array or a
    tuple of arrays, one per input stage."""
    import torch
    from repro_torch.lowering import backends as B
    imgs = img if isinstance(img, tuple) else (img,)
    return {n: B.ingest_input(torch.from_numpy(x).to(dev), lp.stages[n])
            for n, x in zip(lp.pipeline.input_stages(), imgs)}


def shape_of(img):
    return (img[0] if isinstance(img, tuple) else img).shape


def check_islands(label, pipe, types, params, img, dev,
                  datapath="exact") -> float:
    """Kernel == plain version on every island; returns max |error|."""
    import torch
    from repro_torch.kernels.stencil import kernel as K
    shape = shape_of(img)
    lp, isls = islands(pipe, types, params, shape, datapath)
    buffers = ingest(lp, img, dev)
    err = 0.0
    for isl, enc in isls:
        ins = [buffers[n] for n in isl.inputs]
        got = K.fused_pipeline(enc, isl.schedule.grid, shape[0])(*ins)
        want = K.fused_pipeline_reference(enc, isl.schedule.grid,
                                          shape[0])(*ins)
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
    f32 = [n for n in lp.order if lp.stages[n].expr_dtype == "f32"
           and lp.stages[n].kind == "expr"]
    print(f"kernel == plain  {label}: {len(isls)} island(s), "
          f"{sum(i.schedule.grid for i, _ in isls)} band step(s), "
          f"max_abs_err {err}" + (f"; stages run in f32: {f32}"
                                  if datapath == "narrow" else ""),
          flush=True)
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


def band_work(isls, nb: int):
    """(bytes, [(operations, peak rate)]) the islands need at batch `nb`:
    each island's inputs read once and outputs written once, in their
    containers; per output pixel of each stage, a multiply and an add per
    integer tap (at the float32 rate, the fastest outside the tensor
    cores) and one op per arithmetic instruction of an expression
    program (f64 programs at the card's f64 rate, f32 ones at the f32
    rate)."""
    from repro_torch.kernels.stencil import kernel as K
    moved = int_ops = f64_ops = f32_ops = 0
    for _, enc in isls:
        for key in ("in_slot", "out_slot"):
            moved += sum(nb * d["H"] * d["W"] * d["esize"]
                         for _, d in enc.slots(key))
        for d in enc.rows():
            px = nb * d["H"] * d["W"]
            if d["kind"] == K.KIND_INTLINEAR:
                int_ops += px * 2 * d["tap_count"]
            elif d["kind"] == K.KIND_EXPR:
                code = enc.prog[d["prog_begin"]:d["prog_begin"]
                                + d["prog_len"]]
                n = px * int(sum(op not in (K.OP_REF, K.OP_CONST)
                                 for op in code[:, 0]))
                if d["f32"]:
                    f32_ops += n
                else:
                    f64_ops += n
    return moved, [(int_ops, PEAK_OPS_PER_S), (f64_ops, F64_OPS_PER_S),
                   (f32_ops, PEAK_OPS_PER_S)]


# pipelines phase 2 times at the serving shape; the first three also in
# the split (every tile in global memory, column tile 128)
TIMED = ("usm", "hcd", "dus_ext", "of", "of_pyramid")
SPLIT = ("usm", "hcd", "dus_ext")


def band_kernel_times(dev, card, params) -> dict:
    """Phase 2's timing, at the serving shape 4x1080x1920: per pipeline
    (`TIMED`) each island's column tiles, shared memory, residency,
    registers and tile placement (none may be global); the kernel's time
    warm and with the L2 flushed; its bound; for `SPLIT` the time with
    every tile in global memory and at column tiles of 128; for of the
    narrow lowering's time (its outputs equal the exact one's); and the
    plain version's time on usm and of."""
    import torch

    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.lowering.cuda_backend import island_program
    from repro_torch.pipelines import ALL
    from repro_torch.pipelines.types import load_types
    shape = (4,) + FRAME
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    places = ("shared", "global", "none")
    out = {}
    print(f"fused_band.cu ptxas, the kernel without and with f32 stages "
          f"({card}): {ptxas_lines('fused_band', 'fused_band_kernel')}",
          flush=True)

    def launcher(encs, bufs):
        calls = [(K.fused_pipeline(e, i.schedule.grid, shape[0]),
                  [bufs[n] for n in i.inputs]) for i, e in encs]
        return lambda: [o for f, a in calls for o in f(*a)]

    def launches_of(run):
        """The band kernel's launches in one call of `run`, counted from
        0 after the warm-up call."""
        K.LAUNCHES["fused_band"] = 0
        run()
        n = K.LAUNCHES["fused_band"]
        assert n > 0, "the band kernel never launched"
        return n

    def describe(name, isls):
        for isl, enc in isls:
            occ = K.occupancy(enc, dev)
            items = shape[0] * isl.schedule.grid * enc.ntiles
            print(f"fused_band {name} island {isl.idx} "
                  f"{'x'.join(map(str, shape))} ({card}): column tile "
                  f"{enc.col_tile}, {enc.ntiles} column tiles, {items} "
                  f"work items, {len(isl.stages)} stages, "
                  f"{enc.smem_bytes} B shared a block, "
                  f"{occ['blocks_per_sm']} blocks/SM x {occ['sms']} SMs "
                  f"(grid {K.launch_grid(enc, isl.schedule.grid, 4, dev)}"
                  f"), {occ['registers']} registers and "
                  f"{occ['local_bytes']} B local a thread, "
                  f"{K.THREADS} threads; placement "
                  f"{dict(zip(enc.names, (places[d['place']] for d in enc.rows())))}",
                  flush=True)
            assert enc.ws_per_block == 0 and all(
                d["place"] != K.PLACE_GLOBAL for d in enc.rows()), \
                f"{name}: a 1080p tile in global memory"

    for k, name in enumerate(TIMED):
        lp, isls = islands(ALL[name](), load_types(name),
                           params.get(name, {}), shape)
        bufs = ingest(lp, inputs(name, shape, 20 + 2 * k), dev)
        describe(name, isls)
        run = launcher(isls, bufs)
        want = run()
        calls = launches_of(run)
        ms = cuda_ms(run, 20)
        cold = cold_ms(run, 10, flush)
        moved, ops = band_work(isls, shape[0])
        bound, bound_by = least_ms(moved, ops)
        split = {}
        for label, opts in (("every tile in global memory",
                             {"smem_limit": 0}),
                            ("column tile 128", {"col_tile": 128})):
            if name not in SPLIT:
                break
            # the same column tiles as the default, unless asked
            other = launcher([(i, K.encode_program(
                island_program(lp, i), **{
                    "col_tile": e.col_tile or max(d["W"] for d in e.rows()),
                    **opts}))
                for i, e in isls], bufs)
            same(f"fused_band {name} {label}", other(), want)
            split[label] = cuda_ms(other, 10)
        print(f"fused_band {name} {'x'.join(map(str, shape))} ({card}): "
              f"kernel {ms:.4f} ms warm, {cold:.4f} ms with the L2 "
              f"flushed, bound {bound:.4f} ms ({bound_by}: {moved} B at "
              f"{HBM_BYTES_PER_S:.3g} B/s; integer, f64 and f32 ops "
              f"{[n for n, _ in ops]} at {[r for _, r in ops]} /s), "
              f"{len(isls)} island(s), {calls} launch(es) counted in "
              f"one call" + (
                  "; same kernel warm with " + ", ".join(
                      f"{k_} {v:.4f} ms" for k_, v in split.items())
                  if split else ""), flush=True)
        out[name] = {"ms": ms, "cold_ms": cold, "bound_ms": bound,
                     "bound_by": bound_by, "launches_per_batch": calls}
        if split:
            out[name]["split_ms"] = split
        if name == "of":
            # the narrow lowering: f32 stages and int32-pair carriers;
            # its outputs are the exact lowering's, bit for bit
            nlp, nisls = islands(ALL[name](), load_types(name), {}, shape,
                                 "narrow")
            describe(f"{name} narrow", nisls)
            narrow = launcher(nisls, bufs)
            same(f"fused_band {name} narrow vs exact", narrow(), want)
            n_calls = launches_of(narrow)
            n_ms = cuda_ms(narrow, 20)
            n_cold = cold_ms(narrow, 10, flush)
            n_moved, n_ops = band_work(nisls, shape[0])
            n_bound, n_by = least_ms(n_moved, n_ops)
            f32 = [n for n in nlp.order if nlp.stages[n].expr_dtype == "f32"
                   and nlp.stages[n].kind == "expr"]
            print(f"fused_band {name} narrow {'x'.join(map(str, shape))} "
                  f"({card}): kernel {n_ms:.4f} ms warm, {n_cold:.4f} ms "
                  f"with the L2 flushed (exact: {ms:.4f} / {cold:.4f}), "
                  f"bound {n_bound:.4f} ms ({n_by}; ops {[n for n, _ in n_ops]}"
                  f"), f32 stages {f32}, {n_calls} launch(es) counted in "
                  f"one call; outputs == exact lowering", flush=True)
            out[name]["narrow"] = {"ms": n_ms, "cold_ms": n_cold,
                                   "bound_ms": n_bound, "f32_stages": f32,
                                   "launches_per_batch": n_calls}
        if name in ("usm", "of"):
            (isl, enc), = isls
            plain = K.fused_pipeline_reference(enc, isl.schedule.grid,
                                               shape[0])
            ins = [bufs[n] for n in isl.inputs]
            out[name]["plain_ms"] = cuda_ms(lambda: plain(*ins),
                                            2 if name == "usm" else 1)
            print(f"fused_band {name} plain version ({card}): "
                  f"{out[name]['plain_ms']:.2f} ms; the kernel: {calls} "
                  f"launch(es) per batch of {shape[0]}", flush=True)
    return out


def serve(pipe, types, params, requests, label, card, dev) -> dict:
    """Serve `requests` (frames, or frame pairs) through `PipelineServer`
    at batch 4 on the kernel, with the band kernel's launch count set to
    0 just before and read just after; check every result against the
    plain executor on the card; print frames/s and p50/p99 latency."""
    import numpy as np
    import torch

    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.serve import PipelineServer
    n = len(requests)
    lat = [0.0] * n
    K.LAUNCHES["fused_band"] = 0
    with PipelineServer(pipe, types, params, backend="cuda",
                        batch_size=4, device=dev) as srv:
        srv.warmup([FRAME])
        t_start = time.perf_counter()
        futs = []
        for i, req in enumerate(requests):
            t_sub = time.perf_counter()
            fut = srv.submit(req)
            fut.add_done_callback(
                lambda f, i=i, t_sub=t_sub:
                lat.__setitem__(i, time.perf_counter() - t_sub))
            futs.append(fut)
        results = [f.result(timeout=600) for f in futs]
        t_end = time.perf_counter()
    launches = K.LAUNCHES["fused_band"]
    assert launches > 0, f"serving {label} never launched the kernel"
    assert srv.stats["frames"] == n
    for b in range(0, n, 4):
        batch = requests[b:b + 4]
        stacked = (tuple(np.stack(x) for x in zip(*batch))
                   if isinstance(batch[0], tuple) else np.stack(batch))
        want = run_fixed(pipe, stacked, types, params, backend="torch",
                         device=dev)
        for j in range(len(batch)):
            for k, v in want.items():
                got = results[b + j][k]
                assert got.shape == FRAME and torch.isfinite(got).all()
                if not torch.equal(got, v[j].cpu()):
                    raise AssertionError(f"served {label} frame {b + j} "
                                         f"stage {k} != plain executor")
    lat_ms = sorted(x * 1e3 for x in lat)
    out = {"fps": n / (t_end - t_start),
           "p50_ms": float(np.percentile(lat_ms, 50)),
           "p99_ms": float(np.percentile(lat_ms, 99)),
           "launches": launches, "batches": srv.stats["batches"],
           "padded": srv.stats["padded"]}
    print(f"served {n} {label} {FRAME[0]}x{FRAME[1]} "
          f"{'frame pairs' if isinstance(requests[0], tuple) else 'frames'}"
          f" at batch 4 ({card}): {out['fps']:.2f} frames/s, p50 "
          f"{out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms, "
          f"{launches} kernel launches (warmup included), batches "
          f"{out['batches']}, pad frames {out['padded']}, all equal to the "
          f"plain executor", flush=True)
    return out


# phase 5 runs the analysis on every benchmark at full width
ANALYZED = ("usm", "hcd", "dus", "dus_ext", "of", "of_pyramid")
DESIGNS = ("profile", "cluster(interval)")


def on_card(img, dev):
    """A numpy frame (or frame pair) as tensors on `dev`."""
    import torch
    if isinstance(img, tuple):
        return tuple(torch.from_numpy(a).to(dev) for a in img)
    return torch.from_numpy(img).to(dev)


def analysis_on_the_card(dev, card, params) -> dict:
    """Phase 5: for each pipeline of `ANALYZED` at 1080x1920, `run_plan`
    over interval, affine, intersect, a `ProfilePass` of 4 seeded frames
    (frame pairs) on the card, refine(interval, profile) and
    cluster(interval), timed per pass; profile ⊆ interval nesting; the
    interval column's design equal to the committed one; the profile and
    cluster designs through the kernel at 4x1080x1920 on fresh frames,
    each `torch.equal` to the plain version, with the band kernel's
    launches counted from 0 in one call; for `of`, `ProfilePass`'s
    statistics on the card timed against the plain host version
    (`np_alpha_bits` on numpy copies of the same stages)."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.analysis import (ProfilePass, clear_memo, cluster,
                                      refine, run_plan)
    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.pipelines import ALL
    from repro_torch.pipelines.types import design_from_plan, load_types
    out = {}
    clear_memo()
    for k, name in enumerate(ANALYZED):
        pipe, p = ALL[name](), params.get(name, {})
        samples = [on_card(inputs(name, FRAME, 300 + 10 * k + 2 * i), dev)
                   for i in range(4)]
        prof = ProfilePass(samples, params=p, device=dev)
        with obs.tracing() as tr:
            t0 = time.perf_counter()
            plan = run_plan(pipe, ["interval", "affine", "intersect", prof,
                                   refine("interval", prof),
                                   cluster("interval")],
                            betas={n: 4 for n in pipe.stages})
            plan_s = time.perf_counter() - t0
        (top,) = tr.spans("analysis.run_plan")
        pass_s = {s.attrs["column"]: s.t1 - s.t0
                  for s in tr.spans("analysis.pass")
                  if s.parent_id == top.span_id}
        sums = {c: sum(plan.alphas(c).values()) for c in plan.columns}
        plan.check_nesting(["profile", "interval"])
        plan.check_nesting(["interval", "cluster(interval)"])
        assert design_from_plan(plan, "interval") == load_types(name), \
            f"{name}: the interval design != pipelines/types/{name}_b4.json"
        print(f"analysis {name} {FRAME[0]}x{FRAME[1]} ({card}): run_plan "
              f"{plan_s:.4f} s; seconds a pass "
              f"{ {c: round(v, 4) for c, v in pass_s.items()} }; sum of "
              f"alphas a column {sums}; profile ⊆ interval ⊆ "
              f"cluster(interval) holds; the interval design equals the "
              f"committed one", flush=True)
        row = {"plan_s": plan_s, "pass_s": pass_s, "alpha_sums": sums,
               "designs": {}}
        img = inputs(name, (4,) + FRAME, 500 + 2 * k)
        served = run_fixed(pipe, img, load_types(name), p, backend="cuda",
                           device=dev)
        for col in DESIGNS:
            design = design_from_plan(plan, col)
            run_fixed(pipe, img, design, p, backend="cuda", device=dev)
            K.LAUNCHES["fused_band"] = 0
            got = run_fixed(pipe, img, design, p, backend="cuda",
                            device=dev)
            torch.cuda.synchronize()
            launches = K.LAUNCHES["fused_band"]
            assert launches > 0, f"{name} {col}: the kernel never launched"
            want = run_fixed(pipe, img, design, p, backend="torch",
                             device=dev)
            for n in pipe.outputs:
                assert got[n].shape[0] == 4 and torch.isfinite(got[n]).all()
                if not torch.equal(got[n], want[n]):
                    raise AssertionError(f"{name} {col} design: kernel != "
                                         f"plain version on {n}")
            differs = float(np.mean([
                (got[n] != served[n]).double().mean().item()
                for n in pipe.outputs]))
            row["designs"][col] = {"launches": launches,
                                   "differs_from_interval": differs}
            print(f"analysis {name} {col} design 4x{FRAME[0]}x{FRAME[1]} "
                  f"({card}): kernel == plain version, {launches} "
                  f"launch(es) counted in one call; outputs differ from "
                  f"the interval design's on {100 * differs:.4f}% of "
                  f"pixels", flush=True)
        if name == "of":
            row.update(profile_times(pipe, samples, dev, card))
        out[name] = row
    clear_memo()
    return out


def profile_times(pipe, samples, dev, card) -> dict:
    """`of`'s profile on the card (statistics where the float executor's
    stage tensors are) against the plain host version (the same stages
    copied to numpy, `np_alpha_bits`); both equal.  Host clock around
    synchronized calls, 3 and 2 runs."""
    import numpy as np
    import torch

    from repro_torch.core.profile import profile_pipeline
    from repro_torch.dsl.exec import make_profile_runner
    runner = make_profile_runner(pipe, device=dev)

    def host_runner(img, p):
        return {n: v.cpu().numpy() for n, v in runner(img, p).items()}

    def timed(fn, reps):
        secs = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        return res, secs

    _, float_s = timed(lambda: [runner(im, {}) for im in samples], 3)
    card_res, card_s = timed(
        lambda: profile_pipeline(pipe, samples, runner), 3)
    host_res, host_s = timed(
        lambda: profile_pipeline(pipe, samples, host_runner), 2)
    assert card_res.alpha_max == host_res.alpha_max
    assert card_res.alpha_avg == host_res.alpha_avg
    assert card_res.observed_range == host_res.observed_range
    for n, (bits, cum) in host_res.cdf.items():
        assert np.array_equal(card_res.cdf[n][1], cum), n
    print(f"profile of, {len(samples)} frame pairs {FRAME[0]}x{FRAME[1]} "
          f"({card}): float executor alone {float_s} s; ProfilePass "
          f"statistics on the card {card_s} s; plain host version "
          f"(np_alpha_bits on numpy copies) {host_s} s; the two equal",
          flush=True)
    return {"float_s": float_s, "profile_card_s": card_s,
            "profile_host_s": host_s}


# phase 6 searches three benchmarks at full width under the budgets of
# benchmarks/run.py:473 `_design_search`; the calibration images take
# the seeds of the JAX package's benchmark constructors
# (src/repro/pipelines/workflows.py: make_usm 23, make_hcd 11,
# make_dus_ext 37)
SEARCHED = (("usm", 23, 50.0), ("hcd", 11, 40.0), ("dus_ext", 37, 45.0))
DSE_ITERS = 24
DSE_SMALL = (32, 32)


def dse_setup(name, seed, shape, dev, params):
    """(pipeline, params, calibration images, plan) of one search: 2
    images of the port's `pipelines.data.image_set` and a plan of the
    interval column and a `ProfilePass` of those images on `dev`."""
    from repro_torch.analysis import ProfilePass, run_plan
    from repro_torch.pipelines import ALL
    from repro_torch.pipelines.data import image_set
    pipe, p = ALL[name](), params.get(name, {})
    images = image_set(2, shape, seed)
    plan = run_plan(pipe, ["interval",
                           ProfilePass(images, params=p, device=dev)])
    return pipe, p, images, plan


def dse_reset() -> None:
    """Counts and caches of the search from 0: the executor cache (every
    candidate builds its executor anew) and the dse counters."""
    from repro_torch.dse import DSE_STATS
    from repro_torch.dsl.exec import EXEC_CACHE_STATS, clear_executor_cache
    clear_executor_cache()
    EXEC_CACHE_STATS.reset()
    DSE_STATS.reset()


def discrete(res) -> dict:
    """A search's result without its measured error (psnr, max_abs_err
    of each point): alphas, betas, strategies, meets_budget, costs,
    evaluations, clusters."""
    d = res.to_json_dict()
    for p in d["frontier"]["points"] + [d["chosen"] or {}]:
        p.pop("psnr", None)
        p.pop("max_abs_err", None)
    return d


def psnr_rel(a, b) -> float:
    """Largest relative difference of two equal searches' PSNRs."""
    return max([abs(p.psnr - q.psnr) / abs(q.psnr) for p, q in
                zip(a.frontier.points(), b.frontier.points())], default=0.0)


def device_split(prof, path, window) -> dict:
    """From `prof`'s trace (written to `path`): the wall ms of the
    `window` annotation, the device's busy ms in it, and device ms (and
    kernel count) by kind: the band kernel, reductions, other kernels,
    copies."""
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    win, = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e["name"] == window and e.get("cat") == "user_annotation"]
    kinds = {"fused_band": [], "reductions": [], "other kernels": [],
             "copies": []}
    for e in spans:
        cat, name = e.get("cat"), e["name"]
        a, b = max(e["ts"], win[0]), min(e["ts"] + e["dur"], win[1])
        if b <= a or cat not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if cat != "kernel":
            kind = "copies"
        elif "fused_band" in name:
            kind = "fused_band"
        elif "reduce" in name:
            kind = "reductions"
        else:
            kind = "other kernels"
        kinds[kind].append((a, b))
    every = [s for v in kinds.values() for s in v]
    return {"wall_ms": (win[1] - win[0]) / 1e3, "busy_ms": busy_ms(every),
            "ms": {k: busy_ms(v) for k, v in kinds.items()},
            "count": {k: len(v) for k, v in kinds.items()}}


def design_search_on_the_card(dev, card, params) -> dict:
    """Phase 6: `run_design_search` on each of `SEARCHED` at 1080x1920
    through the band kernel (see the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import obs
    from repro_torch.analysis import clear_memo
    from repro_torch.core import cost_model
    from repro_torch.dse import (DSE_STATS, ErrorBudget, Evaluator,
                                 run_design_search, seed_alphas)
    from repro_torch.dsl.exec import EXEC_CACHE_STATS, clear_executor_cache
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.lowering import lower, partition_islands
    out = {}
    trace = ROOT / "chiprun_out" / "dse_trace.json"
    trace.parent.mkdir(exist_ok=True)
    for name, seed, min_psnr in SEARCHED:
        clear_memo()
        pipe, p, images, plan = dse_setup(name, seed, FRAME, dev, params)
        budget = ErrorBudget(min_psnr=min_psnr)
        kw = dict(params=p, seed=0, anneal_iters=DSE_ITERS, backend="cuda",
                  device=dev, verify=True)

        # (a) the search, timed, band-kernel launches counted from 0
        dse_reset()
        torch.cuda.synchronize()
        K.LAUNCHES["fused_band"] = 0
        with obs.tracing() as tr:
            t0 = time.perf_counter()
            res = run_design_search(pipe, plan, images, budget, **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launches = K.LAUNCHES["fused_band"]
        misses, evaluated = EXEC_CACHE_STATS["misses"], DSE_STATS["evaluated"]
        host_s = {k: sum(s.t1 - s.t0 for s in tr.spans(k))
                  for k in ("lowering.lower", "lowering.encode",
                            "dse.evaluate")}
        pts = res.frontier.points()
        bad = [q.strategy for q in pts if not (q.verified
                                                and q.oracle_exact)]
        assert not bad, f"{name}: frontier points not verified or not " \
                        f"oracle-exact, from {bad}"
        assert evaluated == res.evaluations

        # one launch per island: for every evaluated candidate and every
        # verified point, and for one fresh candidate counted alone
        if res.chosen is not None:
            a, b = res.chosen.alphas, res.chosen.betas
        else:
            a, b = seed_alphas(plan), res.beta_result.betas
        ev = Evaluator(pipe, plan.signed(res.plan_column), images, budget,
                       params=p, backend="cuda", device=dev)
        n_isl = len(partition_islands(lower(pipe, ev.types_of(a, b),
                                            params=p), FRAME).islands)
        assert launches == n_isl * (evaluated + len(pts)), \
            (f"{name}: {launches} band-kernel launches for {evaluated} "
             f"candidates and {len(pts)} verified points of {n_isl} "
             f"island(s)")
        clear_executor_cache()
        torch.cuda.synchronize()
        K.LAUNCHES["fused_band"] = 0
        ev.evaluate(a, b, strategy="fresh")
        torch.cuda.synchronize()
        fresh = K.LAUNCHES["fused_band"]
        assert fresh == n_isl, f"{name}: {fresh} launches for one fresh " \
                               f"candidate of {n_isl} island(s)"

        # the chosen design against the float design (the JAX
        # benchmark's gate)
        flt = cost_model.design_cost(pipe, cost_model.float_design(pipe))
        flt_area = flt.lut_bits + flt.dsp_bits
        ch = res.chosen
        if ch is not None:
            assert ch.meets_budget and ch.power < flt.power_proxy \
                and ch.area < flt_area, \
                (f"{name}: the chosen design (power {ch.power}, area "
                 f"{ch.area}) does not beat the float design (power "
                 f"{flt.power_proxy}, area {flt_area}) within budget")

        # (b) the same search once more under torch.profiler: the same
        # result, and where the device's time went
        dse_reset()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("chip_smoke.dse"):
                again = run_design_search(pipe, plan, images, budget, **kw)
                torch.cuda.synchronize()
        assert again.to_json_dict() == res.to_json_dict(), \
            f"{name}: a second search gave another result"
        split = device_split(prof, trace, "chip_smoke.dse")

        # (c) the same search at 32x32: on the card == the oracle on the
        # CPU in every field but the measured error
        clear_memo()
        s_pipe, _, s_imgs, s_plan = dse_setup(name, seed, DSE_SMALL, "cpu",
                                              params)
        dse_reset()
        card_res = run_design_search(s_pipe, s_plan, s_imgs, budget, **kw)
        dse_reset()
        cpu_res = run_design_search(s_pipe, s_plan, s_imgs, budget,
                                    **dict(kw, backend="interp",
                                           device="cpu"))
        assert discrete(card_res) == discrete(cpu_res), \
            f"{name}: the 32x32 search on the card != the oracle's on the CPU"
        small_rel = psnr_rel(card_res, cpu_res)

        row = {"seconds": secs, "evaluations": res.evaluations,
               "evaluations_per_s": res.evaluations / secs,
               "frontier": len(pts),
               "chosen": None if ch is None else {
                   "psnr": ch.psnr, "power_vs_float": ch.power
                   / flt.power_proxy, "area_vs_float": ch.area / flt_area},
               "build_s": host_s["lowering.lower"]
               + host_s["lowering.encode"],
               "lower_s": host_s["lowering.lower"],
               "encode_s": host_s["lowering.encode"],
               "evaluate_s": host_s["dse.evaluate"],
               "executor_misses": misses, "islands": n_isl,
               "launches": launches, "fresh_launches": fresh,
               "traced": split,
               "small_32x32": {"evaluations": card_res.evaluations,
                               "frontier": len(card_res.frontier),
                               "psnr_rel_diff": small_rel}}
        out[name] = row
        ms = split["ms"]
        chosen = "no design chosen" if ch is None else (
            f"chosen design {ch.psnr:.4f} dB, power "
            f"{row['chosen']['power_vs_float']:.4f} and area "
            f"{row['chosen']['area_vs_float']:.4f} of the float design's")
        print(f"design search {name} 2x{FRAME[0]}x{FRAME[1]}, budget "
              f"{min_psnr} dB ({card}): {secs:.4f} s, {res.evaluations} "
              f"evaluations ({row['evaluations_per_s']:.2f}/s), frontier "
              f"{len(pts)} (all verified, oracle-exact), {chosen}; host: "
              f"lowering {host_s['lowering.lower']:.4f} s + encoding "
              f"{host_s['lowering.encode']:.4f} s over {misses} executor "
              f"builds, evaluations {host_s['dse.evaluate']:.4f} s; "
              f"fused_band {launches} launches = {n_isl} island(s) x "
              f"({evaluated} candidates + {len(pts)} verified), {fresh} "
              f"for one fresh candidate", flush=True)
        print(f"design search {name} traced ({card}): window "
              f"{split['wall_ms']:.3f} ms, device busy "
              f"{split['busy_ms']:.3f} ms "
              f"({100 * split['busy_ms'] / split['wall_ms']:.2f}%); "
              f"fused_band {ms['fused_band']:.3f} ms "
              f"({split['count']['fused_band']}), reductions "
              f"{ms['reductions']:.3f} ms ({split['count']['reductions']}), "
              f"other kernels {ms['other kernels']:.3f} ms "
              f"({split['count']['other kernels']}), copies "
              f"{ms['copies']:.3f} ms ({split['count']['copies']}); same "
              f"result as the timed search", flush=True)
        print(f"design search {name} {DSE_SMALL[0]}x{DSE_SMALL[1]}: card "
              f"(cuda) == CPU oracle (interp) in every field but the "
              f"measured error, {card_res.evaluations} evaluations, "
              f"frontier {len(card_res.frontier)}, PSNR relative "
              f"difference at most {small_rel}", flush=True)
    clear_memo()
    return out


# phase 7 runs the SMT analysis on every benchmark at the default
# `SMTConfig` (a 30 s budget a pipeline) beside interval and the phase-5
# profile (the same samples); dus and dus_ext also phase-split
SMT_PHASES = ("dus", "dus_ext")
# ... and holds the card's engine to the CPU's, deadline-free at the
# default node budgets
SMT_CPU_CHECK = ("usm", "dus", "dus_ext")
# ... and runs the SMT column at the default budget on the host's CPU
# too where the card's run reaches the deadline: the alphas the
# engine's speed decides
SMT_CPU_BUDGET = ("hcd", "of", "of_pyramid")


def smt_pass_stats(tr) -> dict:
    """Per SMT column of one traced `run_plan`: the seconds its pass took
    and the boxes its stages explored (`smt.stage` spans under it)."""
    by_id = {s.span_id: s for s in tr.spans()}

    def column_of(sp):
        while sp is not None and sp.name != "analysis.pass":
            sp = by_id.get(sp.parent_id)
        return None if sp is None else sp.attrs.get("column")

    out = {}
    for sp in tr.spans("analysis.pass"):
        out[sp.attrs["column"]] = {"s": sp.t1 - sp.t0, "boxes": 0}
    for sp in tr.spans("smt.stage"):
        out[column_of(sp)]["boxes"] += sp.attrs.get("boxes", 0)
    return out


def smt_divergence(pipe, stage, bounds, dev) -> str:
    """Where the card's engine first leaves the CPU's on `stage`: one
    forward sweep of its op table over a seeded frontier on both devices,
    def by def; the first def whose bounds differ, with its op."""
    import numpy as np
    import torch

    from repro_torch.smt import encoder as E
    from repro_torch.smt import solver as S
    csp, _ = E.encode_stage(pipe, stage, bounds)
    prog = E.compile_csp(csp)
    rng = np.random.default_rng(0)
    lo0 = np.where(np.isfinite(prog.init_lo), prog.init_lo, -1e3)
    hi0 = np.where(np.isfinite(prog.init_hi), prog.init_hi, 1e3)
    u = np.sort(rng.random((2, 64, prog.nvars)), axis=0)
    lo = lo0 + (hi0 - lo0) * u[0]
    hi = lo0 + (hi0 - lo0) * u[1]
    ops = {v: k for k, v in E.OPCODES.items()}
    cols = {}
    for d in (dev, torch.device("cpu")):
        dp = E.device_program(prog, d)
        tlo, thi = torch.from_numpy(lo).to(d), torch.from_numpy(hi).to(d)
        cols[d.type] = [tuple(t.cpu().numpy() for t in
                              S._b_forward(dp, k, tlo, thi))
                        for k in range(prog.ndefs)]
    for k, (a, b) in enumerate(zip(cols[dev.type], cols["cpu"])):
        for x, y in zip(a, b):
            x, y = np.broadcast_to(x, (64,)), np.broadcast_to(y, (64,))
            if not (np.array_equal(np.isnan(x), np.isnan(y)) and
                    np.array_equal(x[~np.isnan(x)].view(np.int64),
                                   y[~np.isnan(y)].view(np.int64))):
                return (f"def {k} ({ops[int(prog.opcode[k])]}, pow "
                        f"{int(prog.pow_n[k])}) of {stage}'s CSP")
    return f"no def of {stage}'s forward sweep differs"


def smt_on_the_card(dev, card, params) -> dict:
    """Phase 7: (a) for each pipeline of `ANALYZED` at 1080x1920,
    `run_plan` over interval, the phase-5 `ProfilePass` (the same
    samples, on the card) and "smt" at the default `SMTConfig` (and
    "smt-phase-split" on `SMT_PHASES`), the batched engine on the card:
    seconds and boxes a pass, the stages that kept their seed when the
    budget ran out, the sum of alphas a column, and profile ⊆ smt ⊆
    interval; (b) each SMT design through the band kernel at
    4x1080x1920 on fresh frames, `torch.equal` to the plain version,
    with the kernel's launches counted from 0 in one call; (c)
    `analyze_smt` deadline-free at the default node budgets on
    `SMT_CPU_CHECK`, on the card and on the CPU: seconds, boxes a
    second, and every stage's range equal on both; (d) the SMT column
    at the default `SMTConfig` on the host's CPU for `SMT_CPU_BUDGET`,
    whose card runs reach the deadline: seconds, boxes, stages that
    kept their seed and the sum of alphas beside the card's."""
    import torch

    from repro_torch import obs
    from repro_torch.analysis import (ProfilePass, clear_memo, make_pass,
                                      run_plan)
    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.pipelines import ALL
    from repro_torch.pipelines.types import design_from_plan
    from repro_torch.smt import SMTConfig, analyze_smt
    from repro_torch.smt import solver as S
    t_phase = time.perf_counter()
    out = {"pipelines": {}, "card_vs_cpu": {}}
    clear_memo()
    for k, name in enumerate(ANALYZED):
        pipe, p = ALL[name](), params.get(name, {})
        samples = [on_card(inputs(name, FRAME, 300 + 10 * k + 2 * i), dev)
                   for i in range(4)]
        passes = ["interval", ProfilePass(samples, params=p, device=dev),
                  make_pass("smt", device=dev)]
        cols = ["smt"]
        if name in SMT_PHASES:
            passes.append(make_pass("smt-phase-split", device=dev))
            cols.append("smt-phase-split")
        with obs.tracing() as tr:
            plan = run_plan(pipe, passes, betas={n: 4 for n in pipe.stages})
        stats = smt_pass_stats(tr)
        sums = {c: sum(plan.alphas(c).values()) for c in plan.columns}
        for c in cols:
            plan.check_nesting(["profile", c, "interval"])
        starved = {c: [n for note in plan.provenance[c].notes
                       if note.startswith("budget-exhausted")
                       for n in note.split(": ", 1)[1].split(", ")]
                   for c in cols}
        row = {"pass_s": {c: v["s"] for c, v in stats.items()},
               "boxes": {c: stats[c]["boxes"] for c in cols},
               "budget_exhausted": starved, "alpha_sums": sums,
               "designs": {}}
        for c in cols:
            print(f"smt {name} {FRAME[0]}x{FRAME[1]} column {c} ({card}): "
                  f"{stats[c]['s']:.4f} s, {stats[c]['boxes']} boxes "
                  f"({stats[c]['boxes'] / stats[c]['s']:.1f}/s), stages "
                  f"that kept their seed at the 30 s budget: "
                  f"{starved[c] or 'none'}; sum of alphas profile "
                  f"{sums['profile']} / {c} {sums[c]} / interval "
                  f"{sums['interval']}; profile ⊆ {c} ⊆ interval holds",
                  flush=True)
        img = inputs(name, (4,) + FRAME, 700 + 2 * k)
        for c in cols:
            design = design_from_plan(plan, c)
            run_fixed(pipe, img, design, p, backend="cuda", device=dev)
            torch.cuda.synchronize()
            K.LAUNCHES["fused_band"] = 0
            got = run_fixed(pipe, img, design, p, backend="cuda",
                            device=dev)
            torch.cuda.synchronize()
            launches = K.LAUNCHES["fused_band"]
            assert launches > 0, f"{name} {c}: the kernel never launched"
            want = run_fixed(pipe, img, design, p, backend="torch",
                             device=dev)
            for n in pipe.outputs:
                assert got[n].shape[0] == 4 and torch.isfinite(got[n]).all()
                if not torch.equal(got[n], want[n]):
                    raise AssertionError(f"{name} {c} design: kernel != "
                                         f"plain version on {n}")
            row["designs"][c] = {"launches": launches,
                                 "phase_stages": sorted(design.phases)}
            print(f"smt {name} {c} design 4x{FRAME[0]}x{FRAME[1]} ({card}): "
                  f"kernel == plain version, {launches} launch(es) counted "
                  f"in one call; residue types on "
                  f"{sorted(design.phases) or 'no stage'}", flush=True)
        out["pipelines"][name] = row
        clear_memo()
    cfg = SMTConfig(time_budget_s=float("inf"))
    for name in SMT_CPU_CHECK:
        res, row = {}, {}
        for d in (dev, torch.device("cpu")):
            S.STATS.reset()
            t0 = time.perf_counter()
            res[d.type] = analyze_smt(ALL[name](), config=cfg, device=d)
            secs = time.perf_counter() - t0
            row[d.type] = {"s": secs, "boxes": S.STATS["boxes"],
                           "boxes_per_s": S.STATS["boxes"] / secs}
        got, want = res[dev.type], res["cpu"]
        diff = [n for n in want if (got[n].range.lo, got[n].range.hi) !=
                (want[n].range.lo, want[n].range.hi)]
        row["equal"] = not diff
        out["card_vs_cpu"][name] = row
        c, h = row[dev.type], row["cpu"]
        print(f"smt {name} deadline-free, default node budgets ({card}): "
              f"card {c['s']:.4f} s, {c['boxes']} boxes "
              f"({c['boxes_per_s']:.1f}/s); CPU {h['s']:.4f} s, "
              f"{h['boxes']} boxes ({h['boxes_per_s']:.1f}/s); "
              f"{'every stage equal' if not diff else 'DIFFER'}",
              flush=True)
        if diff:
            bounds = {n: r.range for n, r in want.items()}
            for n in diff:
                print(f"  {name} {n}: card {got[n].range} != CPU "
                      f"{want[n].range}; "
                      f"{smt_divergence(ALL[name](), n, bounds, dev)}",
                      flush=True)
            raise AssertionError(f"smt {name}: the card's ranges differ "
                                 f"from the CPU's on {diff}")
    out["cpu_at_the_budget"] = {}
    for name in SMT_CPU_BUDGET:
        pipe = ALL[name]()
        clear_memo()
        with obs.tracing() as tr:
            plan = run_plan(pipe, ["interval",
                                   make_pass("smt", device="cpu")])
        stats = smt_pass_stats(tr)["smt"]
        plan.check_nesting(["smt", "interval"])
        total = sum(plan.alphas("smt").values())
        starved = [n for note in plan.provenance["smt"].notes
                   if note.startswith("budget-exhausted")
                   for n in note.split(": ", 1)[1].split(", ")]
        card_row = out["pipelines"][name]
        out["cpu_at_the_budget"][name] = {
            "s": stats["s"], "boxes": stats["boxes"], "alpha_sum": total,
            "budget_exhausted": starved}
        print(f"smt {name} at the default budget on the host's CPU "
              f"({card}): {stats['s']:.4f} s, {stats['boxes']} boxes, "
              f"stages that kept their seed {starved or 'none'}, sum of "
              f"alphas {total} (card {card_row['alpha_sums']['smt']}, "
              f"{card_row['boxes']['smt']} boxes; interval "
              f"{card_row['alpha_sums']['interval']}); smt ⊆ interval "
              f"holds", flush=True)
    clear_memo()
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"smt phase ({card}): {out['phase_s']:.2f} s", flush=True)
    return out


# phase 8 runs the paper's tables on the card and on the host's CPU, the
# Figure 4 workflow at full width and the runtime telemetry
TABLES_ON_BOTH = ("table2_hcd_ranges", "table3_hcd_power",
                  "table4_hcd_bitwidths", "table5_usm_bitwidths",
                  "table6_usm_power", "table7_dus_power",
                  "table8_dus_bitwidths", "table9_of_bitwidths",
                  "table10_of_power", "table12_design_frontier",
                  "fig5_cdf", "fig6_beta_sweep")
# optical flow's beta search at 1080x1920 takes over 20 s of host work
# (a fresh 30-stage encode a candidate), so (b) leaves it out
WORKFLOWS = ("usm", "hcd", "dus")


def numpy_rules_on_the_card(dev, card) -> dict:
    """How the card's elementwise ops meet numpy's rules outside the band
    kernel (`core.npops` keeps the card's own `sqrt` and `pow`): values
    of `npops.npow` (torch's `pow` on the card) that differ from numpy's
    ``x ** n``, and of ``|x| ** (1/3)``, of 200,000 uniform f64 in
    [-1e3, 1e3] (seed 0); the card's `sqrt` against `np.sqrt`; npops'
    min/max of +0 and -0 against numpy's."""
    import numpy as np
    import torch

    from repro_torch.core import npops
    x = np.random.default_rng(0).uniform(-1e3, 1e3, 200000)
    t = torch.from_numpy(x).to(dev)
    out = {}
    for n in (3, 4, 5, -1, -3):
        got = npops.npow(t, n).cpu().numpy()
        want = x ** n          # numpy's `**`, as the reference evaluates
        out[f"pow{n}"] = int(np.count_nonzero(got != want))
    ax = np.abs(x)
    got = npops.power(torch.from_numpy(ax).to(dev), 1.0 / 3).cpu().numpy()
    out["root3"] = int(np.count_nonzero(got != ax ** (1.0 / 3)))
    got = npops.sqrt(torch.from_numpy(ax).to(dev)).cpu().numpy()
    out["sqrt"] = int(np.count_nonzero(got != np.sqrt(ax)))
    z = np.array([0.0, -0.0, -0.0, 0.0] * 1001)
    a, b = torch.from_numpy(z).to(dev), torch.from_numpy(z[::-1].copy()).to(
        dev)
    for name, fn, ref in (("minimum", npops.minimum, np.minimum),
                          ("maximum", npops.maximum, np.maximum)):
        got = fn(a, b).cpu().numpy()
        out[name] = int(np.count_nonzero(np.signbit(got) !=
                                         np.signbit(ref(z, z[::-1]))))
    print(f"numpy rules on the card ({card}): values differing from numpy "
          f"of 200000 (seed 0): " + ", ".join(f"{k} {v}"
                                               for k, v in out.items()),
          flush=True)
    assert out["sqrt"] == 0 and out["minimum"] == out["maximum"] == 0
    return out


def tables_on_both(dev, card) -> dict:
    """Phase 8 (a): the paper's tables at the reference's sizes through
    `repro_torch.benchmarks.paper_tables`, on the card and on the host's
    CPU in this run (the analysis memo cleared between, so each device
    computes its own plans); every row and derived line equal."""
    from repro_torch.analysis import clear_memo
    from repro_torch.benchmarks import paper_tables as PT
    out = {}
    for name in TABLES_ON_BOTH:
        recs = {}
        for d in (dev, "cpu"):
            clear_memo()
            recs[str(d)] = PT.run_table(name, d)
        card_rec, cpu_rec = recs[str(dev)], recs["cpu"]
        if (card_rec["rows"], card_rec["derived"]) != \
                (cpu_rec["rows"], cpu_rec["derived"]):
            raise AssertionError(f"{name}: card and CPU differ:\n"
                                 f"{card_rec}\n{cpu_rec}")
        out[name] = {"card_s": card_rec["seconds"],
                     "cpu_s": cpu_rec["seconds"],
                     "derived": card_rec["derived"]}
        print(f"table {name} ({card}): {card_rec['seconds']:.2f} s on the "
              f"card, {cpu_rec['seconds']:.2f} s on the host CPU, rows "
              f"equal: {card_rec['derived']}", flush=True)
    clear_memo()
    return out


def workflow_at_full_width(name, dev, card) -> dict:
    """Phase 8 (b), one benchmark: `make_*` at 1080x1920 with 2 train
    and 2 test images, static alphas, the profile on the
    card, the beta search through the band kernel (launches counted from
    0 after a warm-up evaluation), `design_report`, and the chosen
    design's outputs on one test image equal to the `"interp"` oracle."""
    import warnings

    import torch

    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.pipelines import workflows as W
    t0 = time.perf_counter()
    b = W.ALL_BENCHMARKS[name](n_train=2, n_test=2, shape=FRAME, device=dev)
    t_data = time.perf_counter() - t0
    pipe = b.pipeline
    t0 = time.perf_counter()
    alphas, signed = W.static_alphas(pipe)
    prof = b.profile()
    t_analysis = time.perf_counter() - t0
    calls = [0]
    metric = b.quality_of

    def counted(r, f, p):
        calls[0] += 1
        return metric(r, f, p)

    b.quality_of = counted
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        b.mean_quality(W.types_from_alpha(pipe, alphas, signed,
                                          {n: 4 for n in pipe.stages}),
                       images=b.train_images[:1])       # warm-up
        torch.cuda.synchronize()
        calls[0] = 0
        K.LAUNCHES["fused_band"] = 0
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            res = b.run_beta_search(prof.alpha_max, signed, beta_hi=10)
        torch.cuda.synchronize()
        t_search = time.perf_counter() - t0
        launches = K.LAUNCHES["fused_band"]
        scored = calls[0]
        types = W.types_from_alpha(pipe, prof.alpha_max, signed, res.betas)
    b.quality_of = metric
    assert launches >= scored > 0, (launches, scored)
    q_test = b.mean_quality(types)
    rep = W.design_report(pipe, types)
    img = b.test_images[0]
    got = run_fixed(pipe, img, types, b.params, backend="cuda", device=dev)
    want = run_fixed(pipe, img, types, b.params, backend="interp",
                     device=dev)
    for k, v in got.items():
        assert v.shape == FRAME and torch.isfinite(v).all(), k
        if not torch.equal(v, want[k]):
            raise AssertionError(f"workflow {name}: chosen design's {k} "
                                 f"!= the interp oracle")
    row = {"sum_beta": sum(res.betas.values()),
           "sum_alpha_sa": sum(alphas.values()),
           "sum_alpha_max": sum(prof.alpha_max.values()),
           "quality_train": res.quality, "quality_test": q_test,
           "target": b.quality_target, "evaluations": res.profile_passes,
           "scored_images": scored, "launches": launches,
           "data_s": t_data, "analysis_s": t_analysis, "search_s": t_search,
           "power_x": rep["improvement"]["power"],
           "lut_x": rep["improvement"]["area_lut"]}
    print(f"workflow {name} {FRAME[0]}x{FRAME[1]} ({card}): sum beta "
          f"{row['sum_beta']}, quality {res.quality:.4f} on train / "
          f"{q_test:.4f} on test against target {b.quality_target}, "
          f"{res.profile_passes} evaluations ({scored} image scorings) in "
          f"{t_search:.2f} s, {launches} band-kernel launches from 0, "
          f"static + profile analysis {t_analysis:.2f} s, data "
          f"{t_data:.2f} s; modeled power x{row['power_x']:.1f}, LUT "
          f"x{row['lut_x']:.1f} vs float; chosen design == interp oracle",
          flush=True)
    return row


def telemetry_on_the_card(dev, card) -> dict:
    """Phase 8 (c): one USM batch of 4 at 1080x1920 served under
    `obs.enable(runtime_ranges=True)` (the server's band-kernel
    executor records the output), and the same batch through the band
    kernel with every stage asked for; outputs equal to the same batch
    with telemetry off, and the `rt.range` records equal to the
    `"interp"` walk's per image on the host CPU (ranges joined, rail
    counts summed).  Headroom a stage; JSONL and Chrome trace under
    `chiprun_out/`; `obs.report`'s stage table."""
    import numpy as np
    import torch

    from repro_torch import obs
    from repro_torch.core.fixedpoint import alpha_for_range
    from repro_torch.dsl.exec import run_fixed
    from repro_torch.obs import report
    from repro_torch.pipelines import usm
    from repro_torch.pipelines.types import load_types
    from repro_torch.serve import PipelineServer
    pipe, types, p = usm.build(), load_types("usm"), dict(usm.DEFAULT_PARAMS)
    imgs = [frames(FRAME, 500 + i) for i in range(4)]
    batch = np.stack(imgs)
    stages = list(pipe.topo_order())
    # a long batch timeout: the four requests make one batch, no pad
    with PipelineServer(pipe, types, p, backend="cuda", batch_size=4,
                        batch_timeout_s=30.0, device=dev) as srv:
        srv.warmup([FRAME])
        off = [f.result(timeout=600) for f in [srv.submit(x) for x in imgs]]
        tr = obs.enable(runtime_ranges=True)
        try:
            t0 = time.perf_counter()
            on = [f.result(timeout=600)
                  for f in [srv.submit(x) for x in imgs]]
            served_s = time.perf_counter() - t0
            every = run_fixed(pipe, batch, types, p, backend="cuda",
                              device=dev, outputs=stages)
            torch.cuda.synchronize()
        finally:
            obs.disable()
    quiet = run_fixed(pipe, batch, types, p, backend="cuda", device=dev,
                      outputs=stages)
    for a, b_ in zip(on, off):
        for k in b_:
            assert torch.equal(a[k], b_[k]), f"served {k}: telemetry changed it"
    for k in quiet:
        assert torch.equal(every[k], quiet[k]), f"{k}: telemetry changed it"
    recs = [dict(e["attrs"]) for e in tr.events("rt.range")]
    served, direct = recs[:len(pipe.outputs)], recs[len(pipe.outputs):]
    assert srv.stats["batches"] == 2 and srv.stats["padded"] == 0, srv.stats
    with obs.tracing(runtime_ranges=True) as host:
        for x in imgs:
            run_fixed(pipe, x, types, p, backend="interp", device="cpu")
    per = {}
    for r in host.events("rt.range"):
        per.setdefault(r["attrs"]["stage"], []).append(r["attrs"])

    def joined(stage, backend):
        rs = per[stage]
        out = dict(rs[0], backend=backend, n=sum(r["n"] for r in rs),
                   min=min(r["min"] for r in rs),
                   max=max(r["max"] for r in rs))
        out["alpha_obs"] = int(alpha_for_range(out["min"], out["max"]))
        out["headroom"] = out["alpha_plan"] - out["alpha_obs"]
        for k in ("sat_lo", "sat_hi", "sat"):
            out[k] = sum(r[k] for r in rs)
        return out

    assert served == [joined(s, "cuda") for s in pipe.outputs], served
    assert direct == [joined(s, "cuda") for s in stages], direct
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    obs.write_jsonl(tr, outdir / "telemetry_usm.jsonl")
    obs.write_chrome_trace(tr, outdir / "telemetry_usm.trace.json")
    table = report.render({"passes": [], "smt_stages": [],
                           "runtime": report.summarize(
                               obs.to_jsonl_records(tr))["runtime"]})
    head = {r["stage"]: r["headroom"] for r in direct}
    print(f"telemetry usm 4x{FRAME[0]}x{FRAME[1]} ({card}): served batch "
          f"{served_s * 1e3:.2f} ms with telemetry on; outputs equal with "
          f"it off; rt.range records equal the interp walk's on the host "
          f"CPU per image, joined; headroom a stage {head}; saturated "
          f"pixels {sum(r['sat'] for r in direct)}", flush=True)
    print(table, flush=True)
    return {"headroom": head, "served_ms": served_s * 1e3,
            "records": len(recs)}


def workflows_on_the_card(dev, card) -> dict:
    """Phase 8: numpy's rules on the card, (a) the tables on the card
    and the host CPU, (b) the Figure 4 workflow at 1080x1920 on
    `WORKFLOWS`, (c) runtime telemetry; the phase's seconds."""
    t_phase = time.perf_counter()
    out = {"numpy_rules": numpy_rules_on_the_card(dev, card)}
    t0 = time.perf_counter()
    out["tables"] = tables_on_both(dev, card)
    out["tables_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["workflows"] = {n: workflow_at_full_width(n, dev, card)
                        for n in WORKFLOWS}
    out["workflows_s"] = time.perf_counter() - t0
    out["telemetry"] = telemetry_on_the_card(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"workflows phase ({card}): {out['phase_s']:.2f} s (tables "
          f"{out['tables_s']:.2f} s, workflows {out['workflows_s']:.2f} s)",
          flush=True)
    return out


def main() -> int:
    t_script = time.perf_counter()
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
    for k, name in enumerate(("of", "of_pyramid")):
        err = max(err, check_islands(
            f"{name} 2x{FRAME[0]}x{FRAME[1]} frame pairs", ALL[name](),
            load_types(name), {}, inputs(name, (2,) + FRAME, 30 + 2 * k),
            dev))
    for k, name in enumerate(("of", "hcd", "usm")):
        err = max(err, check_islands(
            f"{name} 2x{FRAME[0]}x{FRAME[1]} narrow", ALL[name](),
            load_types(name), params.get(name, {}),
            inputs(name, (2,) + FRAME, 40 + 2 * k), dev, datapath="narrow"))
    assert K.LAUNCHES["fused_band"] > before, "the kernel never launched"

    flat = np.full((1,) + FRAME, 117.0)
    out = run_fixed(usm.build(), flat, load_types("usm"), params["usm"],
                    backend="cuda")["masked"]
    assert out.shape == (1,) + FRAME and torch.isfinite(out).all()
    assert torch.equal(out, torch.from_numpy(flat).to(dev)), \
        "USM changed a flat frame"
    print("known answer: USM leaves a flat 1080p frame unchanged", flush=True)
    for name in ("of", "of_pyramid"):
        zero = run_fixed(ALL[name](), (flat, flat), load_types(name),
                         backend="cuda")
        for k, v in zero.items():
            assert v.shape == (1,) + FRAME and torch.isfinite(v).all()
            assert torch.all(v == 0), f"{name}: nonzero flow {k} between " \
                                      f"two equal flat frames"
    print("known answer: two equal flat 1080p frames give zero optical flow "
          "(of, of_pyramid)", flush=True)

    band = band_kernel_times(dev, card, params)

    # -- 2b. the kernel library ---------------------------------------------
    library_rows = kernel_library(dev, card)

    # -- 3. serving: the main path ----------------------------------------
    n_frames = 16
    imgs = [frames(FRAME, 100 + i) for i in range(n_frames)]
    served = serve(usm.build(), load_types("usm"), params["usm"], imgs,
                   "usm", card, dev)
    launches = served["launches"]

    # -- 3b. one traced serving pass: device busy share and its split -----
    trace_serving(usm.build(), load_types("usm"), params["usm"], imgs, card)

    # -- 3c. serving optical flow: frame pairs ----------------------------
    flow = serve(ALL["of"](), load_types("of"), {},
                 [inputs("of", FRAME, 200 + 2 * i) for i in range(n_frames)],
                 "of", card, dev)

    # -- 5. analysis on the card --------------------------------------------
    analysis = analysis_on_the_card(dev, card, params)

    # -- 6. the design search on the card -----------------------------------
    design_search = design_search_on_the_card(dev, card, params)

    # -- 7. the SMT range analysis on the card --------------------------------
    smt = smt_on_the_card(dev, card, params)

    # -- 8. workflows on the card -------------------------------------------
    workflows = workflows_on_the_card(dev, card)

    # -- 9. result lines ---------------------------------------------------
    print(f"chip_smoke: phases 1-8 in {time.perf_counter() - t_script:.2f} s "
          f"({card})", flush=True)
    usm_t = band["usm"]
    print(json.dumps({"kernels": [{
        "name": "fused_band", "route": "cuda",
        "source": "src/repro_torch/kernels/stencil/csrc/fused_band.cu",
        "replaces": "src/repro/kernels/stencil/kernel.py:265",
        "launches": launches, "max_abs_err": err, "ms": usm_t["ms"],
        "plain_ms": usm_t["plain_ms"], "bound_ms": usm_t["bound_ms"],
        "bound_by": usm_t["bound_by"], "library_ms": None,
        "cold_ms": usm_t["cold_ms"],
        "pipelines": {n: {k: v for k, v in t.items() if k != "split_ms"}
                      for n, t in band.items()},
        "serving": {"usm": served, "of": flow},
        "analysis": analysis, "design_search": design_search,
        "smt": smt, "workflows": workflows}]
        + library_rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
