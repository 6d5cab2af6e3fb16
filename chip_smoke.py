#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one card.

    python3 chip_smoke.py

Phases (any failure raises, and the exit code is not 0):

1. print the card's name and power limit; build the five kernel
   libraries (`fused_band.cu`, `stencil.cu`, `qmatmul.cu`, `qdq.cu` under
   `src/repro_torch/kernels/*/csrc/`, and the SMT engine's
   `src/repro_torch/smt/csrc/smt_walk.cu`), one nvcc each, in parallel;
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
   the run); for those of hcd, of and of_pyramid whose card run reached
   the deadline, run the SMT column at the default budget on the host's
   CPU and print its seconds, boxes, seed-kept stages and sum of alphas
   beside the card's; the SMT walk kernels (`smt_hc4`, `smt_grad`):
   their launches in the analysis above, counted from 0 (each must
   launch), and on the throughput workload's CSP (HCD det) at 64, 512
   and 4096 boxes each against its plain version on the card, every bit,
   with ms a launch beside the plain version's and the bound; boxes a
   second of `repro_torch.benchmarks.smt_throughput`'s workload on the
   card and on the host's CPU, with host syncs, device operations and
   walk launches a box and the device's busy share; Table 11 at the
   reference's budgets on the card, through `alpha_delta` against the
   goldens (nesting must hold; a grown alpha is printed); print the
   phase's seconds;
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
9. sharded and f32: print the cards present and each benchmark's band
   grid at 1080 and 1088 rows with the shard counts that divide it; for
   each of the six at 4x1080x1920 (3 and 5 shards) and 4x1088x1920 (2
   and 4), launch the band kernel's band ranges back to back on one
   card, hold them joined `torch.equal` to one whole launch (usm's middle
   range also to its plain version), and print their summed ms with the
   L2 flushed beside the whole launch's; serve one USM batch of 4 at
   1080x1920 through `PipelineServer(backend="sharded")` over every card
   present, launches counted from 0, equal to ``backend="cuda"``; where
   more than one card is present, the sharded executor over all of them
   equal to one card's; the f32 walk (``backend="f32"``) on hcd at
   1080x1920 on the card equal to the host CPU's; the phase's seconds
   (held under 30 s);
10. LM serving: qwen3-4b at full width with seeded random weights (the
   port's dense decoder; no kernel of the port on this path): 8
   requests of 4-token prompts on 4 slots through `ContinuousBatcher`
   and its CUDA graph of the decode step, bf16 and int8 KV (steps/s,
   tokens/s, the step's ms graphed and plain beside its bytes bound,
   peak memory, a traced step); a 128-token fused prefill against 128
   decode steps; the card against the host CPU at 2 layers (forward
   and 4 decode steps); 8-bit weights served and AutoQuant; held under
   60 s;
11. MoE serving: qwen2-moe-a2.7b at full width with seeded random
   weights (`models/moe.py`, no kernel of the port on this path): the
   same 8 requests on 4 slots through the batcher's graphed step, bf16
   KV (steps/s, tokens/s, the graphed and plain step's ms beside the
   bytes bound, peak memory, a traced step); a 128-token fused prefill
   on the card and on the host CPU, within phase 10's tolerance; the
   card against the host CPU at 2 layers (forward and 4 decode steps),
   with the share of tokens routed to the same experts on both; held
   under 120 s;
12. VLM and encoder-decoder serving (no kernel of the port on this
   path): (a) paligemma-3b at full width with seeded random weights:
   the same 8 requests on 4 slots through the batcher's graphed step,
   bf16 KV, text only as the reference serves (steps/s, tokens/s, the
   graphed and plain step's ms beside the bytes bound, peak memory, a
   traced step); one image (256 patch embeddings from `make_batch`) and
   128 text tokens forward, the suffix logits moved by zeroing the
   image (> 1e-3); the card against the host CPU at 2 layers (that
   forward and 4 decode steps, phase 10's tolerance); (b) whisper-medium
   at full width: 1500 frames encoded, 16 decode steps over their cross
   K/V against `decode_train` (atol 0.2 / rtol 0.05, argmax agreement
   >= 0.85); the 8 requests on 4 slots through the graphed step against
   zeroed cross K/V, as the reference's batcher serves; the card against
   the host CPU at 2 encoder and 2 decoder layers (encoder output and 4
   decode steps, phase 10's tolerance); held under 120 s;
13. RWKV6 serving: rwkv6-3b at full width with seeded random weights
   (`models/ssm.py` and the rwkv blocks; no kernel of the port on this
   path): the same 8 requests on 4 slots through the batcher's graphed
   step (steps/s, tokens/s, the graphed and plain step's ms beside the
   bytes bounds of `lm_decode_bytes` and of the parameter tree, peak
   memory, a traced step); a 128-token `prefill_recurrent` against 128
   decode steps at 2 layers (the reference test's depth; atol 0.15 /
   rtol 0.05, the next step's token equal) and at 32 (the next token
   equal; the difference printed beside the same prefill's on the card
   and the host CPU: bf16 rounding noise grows layer by layer on random
   weights, `rwkv_prefill_drift`); the card against the host CPU at
   2 layers, forward and 4 decode steps: layer by layer from the card's
   inputs and states (outputs and WKV states within two bf16 units of
   their largest, logits from the card's last hidden state within
   phase 10's tolerance), and end to end (printed); held under 60 s;
14. print the seconds phases 1-13 took, a `{"kernels": [...]}` line, the
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
    from repro_torch.smt import walk as W
    t_phase = time.perf_counter()
    out = {"pipelines": {}, "card_vs_cpu": {}}
    clear_memo()
    W.LAUNCHES.update(smt_hc4=0, smt_grad=0)
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
    out["walk_launches"] = dict(W.LAUNCHES)
    print(f"smt walk kernels launched in (a), counted from 0 ({card}): "
          f"{out['walk_launches']}", flush=True)
    for k, n in out["walk_launches"].items():
        assert n > 0, f"{k}: the SMT column on the card never launched it"
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
        if not out["pipelines"][name]["budget_exhausted"]["smt"]:
            print(f"smt {name}: every stage finished within the budget on "
                  f"the card ({card}); no host CPU run needed", flush=True)
            continue
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
    out["walks"] = smt_walk_kernels(dev, card)
    out["throughput"] = smt_throughput_on_both(dev, card)
    out["table11"] = table11_on_the_card(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"smt phase ({card}): {out['phase_s']:.2f} s", flush=True)
    return out


# phase 7 (e): the walk kernels on the throughput workload's CSP (HCD
# det, 259 variables) at frontiers of these many boxes; 512 is
# `BPBudget.batch`, the engine's batch
SMT_WALK_N = (64, 512, 4096)
SMT_WALK_MAIN_N = 512


def smt_frontier(prog, seed, n):
    """Seeded random sub-boxes of the CSP's box (even rows on its base
    variables, odd rows on every variable, so some die), with infinite
    bounds, zero bounds of both signs and point intervals."""
    import numpy as np
    rng = np.random.default_rng(seed)
    nv = prog.nvars
    ilo = np.broadcast_to(prog.init_lo, (n, nv))
    ihi = np.broadcast_to(prog.init_hi, (n, nv))
    flo = np.where(np.isfinite(ilo), ilo, -1e3)
    fhi = np.where(np.isfinite(ihi), ihi, 1e3)
    u = np.sort(rng.random((2, n, nv)), axis=0)
    base = np.zeros(nv, bool)
    base[prog.base] = True
    wild = (np.arange(n) % 2 == 1)[:, None]
    keep = (rng.random((n, nv)) < 0.5) | (~wild & ~base)
    lo = np.where(keep, ilo, flo + (fhi - flo) * u[0])
    hi = np.where(keep, ihi, flo + (fhi - flo) * u[1])
    m = rng.random((n, nv))
    lo = np.where(m < 0.04, -np.inf, lo)
    hi = np.where((m > 0.04) & (m < 0.08), np.inf, hi)
    zero = rng.choice([0.0, -0.0], (n, nv))
    z = (m > 0.08) & (m < 0.12) & (wild | ((lo <= 0.0) & (hi >= 0.0)))
    lo, hi = np.where(z, zero, lo), np.where(z, np.abs(hi), hi)
    point = (m > 0.18) & (m < 0.22) & np.isfinite(lo) & (wild | base)
    hi = np.where(point, lo, hi)
    return np.ascontiguousarray(lo), np.ascontiguousarray(hi)


def same_bits(label, got, want) -> None:
    """Every f64 bit equal (a NaN's payload aside, the sign of a zero
    counted), or raise."""
    import numpy as np
    g, w = got.cpu().numpy(), want.cpu().numpy()
    gn, wn = np.isnan(g), np.isnan(w)
    if not (np.array_equal(gn, wn) and np.array_equal(
            g[~gn].view(np.int64), w[~wn].view(np.int64))):
        raise AssertionError(f"{label}: kernel != plain version")


# f64 operations a def step of each opcode costs, forward (with its meet)
# and backward (each variable slot's projection and meet), counted from
# the transfer functions (`solver._b_*`): an add, multiply, divide, square
# root, compare-and-select each one
HC4_FWD_OPS = {0: 7, 1: 7, 2: 18, 3: 20, 4: 11, 5: 9, 6: 9, 7: 7, 8: 7,
               9: 13}
HC4_BWD_OPS = {0: 7, 1: 7, 2: 24, 3: 24, 4: 12, 5: 10, 6: 8, 7: 12, 8: 12,
               9: 8}
# a def step of the gradient walk: its parts, then per variable slot a
# product of intervals (13) and two sums (2)
GRAD_PART_OPS = {0: 0, 1: 0, 2: 0, 3: 22, 4: 6, 5: 3, 6: 6, 7: 0, 8: 0,
                 9: 8}


def walk_bounds(prog, N, rounds, passes, glo, ghi) -> dict:
    """Least times of one hc4 call (`rounds` rounds, `passes` passes over
    N boxes) and of one gradient call: bytes (the frontier read and
    written, the alive flags, the op table; the gradients written) and
    f64 operations (the def steps this run made at `HC4_FWD_OPS` and
    `HC4_BWD_OPS`; for the gradients the defs whose adjoint is not zero
    on each box) at the card's f64 rate."""
    import numpy as np
    nv = prog.nvars
    table = prog.ndefs * (4 * 4 + 4 * 4 + 4 * 8)
    slots = (prog.argv >= 0).sum(axis=1)
    ops_round = sum(HC4_FWD_OPS[int(o)] + HC4_BWD_OPS[int(o)] * max(1, s)
                    for o, s in zip(prog.opcode, slots))
    hc4 = least_ms(2 * 2 * N * nv * 8 + 2 * N + table,
                   [(N * rounds * passes * ops_round, F64_OPS_PER_S)])
    g = glo.cpu().numpy()[:, prog.def_var] != 0.0
    g |= ghi.cpu().numpy()[:, prog.def_var] != 0.0
    per_def = np.array([GRAD_PART_OPS[int(o)] + 15 * s
                        for o, s in zip(prog.opcode, slots)])
    grad = least_ms(2 * N * nv * 8 + 2 * N * nv * 8 + table,
                    [(int((g * per_def).sum()), F64_OPS_PER_S)])
    return {"hc4": hc4, "grad": grad}


def smt_walk_kernels(dev, card) -> dict:
    """Phase 7 (e): each walk kernel against its plain version on the
    card, on seeded frontiers of the throughput workload's CSP at
    `SMT_WALK_N` boxes, every bit of every row; ms a launch of each
    (CUDA events, a fresh copy of the frontier before each hc4 launch,
    outside its window) beside its plain version's and its bound."""
    import numpy as np
    import torch

    from repro_torch.benchmarks.smt_throughput import workload
    from repro_torch.smt import encoder as E
    from repro_torch.smt import solver as S
    from repro_torch.smt import walk as W
    csp, root = workload()
    prog = E.compile_csp(csp)
    dp = E.device_program(prog, dev)
    out = {}
    for N in SMT_WALK_N:
        lo, hi = smt_frontier(prog, N, N)
        alive0 = torch.from_numpy(
            np.random.default_rng(N + 1).random(N) < 0.9).to(dev)
        lo0, hi0 = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
        res = {}
        for way in ("kernel", "plain"):
            tlo, thi = lo0.clone(), hi0.clone()
            stats = {}
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            mid = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            if way == "kernel":
                a = W.hc4_walk(dp, tlo, thi, alive0, 6, stats)
                mid.record()
                g = W.grad_walk(dp, tlo, thi, root)
            else:
                a = S._hc4_plain(dp, tlo, thi, alive0, 6)
                mid.record()
                g = S._gradients_plain(dp, prog.nvars, tlo, thi, root)
            stop.record()
            torch.cuda.synchronize()
            res[way] = {"out": (a, tlo, thi) + tuple(g), "stats": stats,
                        "hc4_ms": start.elapsed_time(mid),
                        "grad_ms": mid.elapsed_time(stop)}
        k, p = res["kernel"]["out"], res["plain"]["out"]
        if not torch.equal(k[0], p[0]):
            raise AssertionError(f"smt_hc4 N={N}: alive != plain version")
        for label, g, w in zip(("lo", "hi", "glo", "ghi"), k[1:], p[1:]):
            same_bits(f"smt walk N={N} {label}", g, w)
        # ms a launch, warm: hc4 on a fresh copy each time, the copy
        # outside the timed window
        tlo, thi = lo0.clone(), hi0.clone()
        pairs = []
        for _ in range(5):
            tlo.copy_(lo0)
            thi.copy_(hi0)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            W.hc4_walk(dp, tlo, thi, alive0, 6)
            e1.record()
            pairs.append((e0, e1))
        torch.cuda.synchronize()
        hc4_ms = sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)
        grad_ms = cuda_ms(lambda: W.grad_walk(dp, lo0, hi0, root), 20)
        st = res["kernel"]["stats"]
        rounds, passes = int(st["rounds"]), int(st["passes"])
        bounds = walk_bounds(prog, N, rounds, passes, k[3], k[4])
        live = int(k[0].sum())
        out[N] = {"hc4_ms": hc4_ms, "grad_ms": grad_ms,
                  "hc4_plain_ms": res["plain"]["hc4_ms"],
                  "grad_plain_ms": res["plain"]["grad_ms"],
                  "rounds": rounds, "passes": passes, "live": live,
                  "hc4_bound_ms": bounds["hc4"][0],
                  "hc4_bound_by": bounds["hc4"][1],
                  "grad_bound_ms": bounds["grad"][0],
                  "grad_bound_by": bounds["grad"][1]}
        r = out[N]
        print(f"smt walk kernels, hcd det ({prog.nvars} variables), "
              f"{N} boxes ({live} live after hc4; {rounds} rounds, "
              f"{passes} pass(es)) ({card}): every bit equal to the plain "
              f"version on the card; smt_hc4 {hc4_ms:.4f} ms a launch "
              f"(plain {r['hc4_plain_ms']:.2f} ms; bound "
              f"{r['hc4_bound_ms']:.4f} ms, {r['hc4_bound_by']}), smt_grad "
              f"{grad_ms:.4f} ms (plain {r['grad_plain_ms']:.2f} ms; bound "
              f"{r['grad_bound_ms']:.4f} ms, {r['grad_bound_by']})",
              flush=True)
    return out


def smt_throughput_on_both(dev, card) -> dict:
    """Phase 7 (f): `repro_torch.benchmarks.smt_throughput`'s workload
    (HCD det >= 2^30, 4,096 nodes) on the card, with its syncs, device
    operations and walk launches a box and the device's busy share, and
    on the host's CPU."""
    from repro_torch.benchmarks import smt_throughput as T
    res = {"card": T.measure(dev), "cpu": T.measure("cpu", counts=False)}
    c, h = res["card"], res["cpu"]
    busy = ("not measured (the profiler saw no device events)"
            if c.get("busy_share") is None
            else f"{100 * c['busy_share']:.2f}% of the traced wall time, "
                 f"{c['busy_s']:.3f} s, "
                 f"{100 * c['busy_share_untraced']:.2f}% of the same "
                 f"call untraced ({c['untraced_s']:.3f} s)")
    print(f"smt throughput, hcd det >= 2^30, {c['nodes']} nodes "
          f"({card}): card {c['boxes_per_s']:.1f} boxes/s ({c['s']:.3f} s, "
          f"{c['status']}), host CPU {h['boxes_per_s']:.1f} boxes/s "
          f"({h['s']:.3f} s, {h['status']}); on the card "
          f"{c['syncs_per_box']:.3f} host syncs a box; traced "
          f"{c['trace_nodes']} nodes: device busy {busy}, "
          f"{c.get('device_ops_per_box', 0):.2f} device operations a box, "
          f"walk launches a box {c.get('walk_launches_per_box')}",
          flush=True)
    assert c["boxes_per_s"] > 0 and h["boxes_per_s"] > 0
    return res


TABLE11_CHILD = (
    "import json, sys, time\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from repro_torch.benchmarks.paper_tables import table11_smt_alphas\n"
    "t0 = time.perf_counter()\n"
    "_, derived = table11_smt_alphas(device='cuda', out_dir=sys.argv[2],\n"
    "                                groups=[sys.argv[1]])\n"
    "print(json.dumps({'s': time.perf_counter() - t0, "
    "'derived': derived}))\n")


def table11_on_the_card(dev, card) -> dict:
    """Phase 7 (g): Table 11 at the reference's budgets on the card
    (`paper_tables.table11_smt_alphas`), its six benchmark groups in six
    processes at once on the one card (the engine leaves the card idle
    most of the time and each group is one host thread; run one after
    another they take 385 s, PR 32 run 2), then `alpha_delta` against
    the committed goldens on the groups' plans joined: a line a group,
    the stages whose alpha grew and the golden rows missing.  The
    nesting profile <= smt <= interval must hold in every group; a grown
    alpha is the engine's speed on this card, printed, not a failure of
    the run."""
    import os

    from repro_torch.benchmarks import alpha_delta
    from repro_torch.benchmarks.paper_tables import table11_makers
    base = ROOT / "chiprun_out" / "paper_tables"
    groups = list(table11_makers(dev))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {g: subprocess.Popen(
        [sys.executable, "-c", TABLE11_CHILD, g, str(base / g)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in groups}
    res = {}
    try:
        for g, proc in procs.items():
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                raise AssertionError(f"table 11 {g}: exit {proc.returncode}"
                                     f"\n{err[-3000:]}")
            res[g] = json.loads(out.strip().splitlines()[-1])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    secs = time.perf_counter() - t0
    joined = {"version": 1, "groups": {}, "device": None}
    for g in groups:
        assert "nesting holds: True" in res[g]["derived"], (g, res[g])
        part = json.loads((base / g / "table11_plans.json").read_text())
        joined["groups"].update(part["groups"])
        joined["device"] = part["device"]
    plans = base / "table11_plans.json"
    plans.write_text(json.dumps(joined, sort_keys=True, indent=1))
    lines, regressed, dropped = alpha_delta.report(str(plans),
                                                   alpha_delta.GOLDEN)
    print(f"table 11 on the card ({card}): {secs:.2f} s for the six "
          f"groups at once ("
          + ", ".join(f"{g} {res[g]['s']:.2f} s" for g in groups)
          + "); nesting holds in every group", flush=True)
    for ln in lines:
        print(f"  {ln}", flush=True)
    verdict = ("equal to the golden or better on every stage"
               if not regressed else f"alpha grew on {regressed}")
    print(f"table 11 on the card against the goldens: {verdict}; golden "
          f"rows missing: {dropped or 'none'}", flush=True)
    return {"s": secs, "group_s": {g: res[g]["s"] for g in groups},
            "regressed": [[str(x) for x in r] for r in regressed],
            "missing": [list(k) for k in dropped]}


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


# phase 9: the shard counts timed at each height (1080 rows are 135 bands
# of 8, 3^3 * 5; 1088 rows are 136, 2^3 * 17)
SHARD_CASES = ((1080, (3, 5)), (1088, (2, 4)))
SHARDED_PHASE_LIMIT_S = 30.0


def band_ranges_on_one_card(dev, card, params, flush) -> dict:
    """Phase 9 (a): per benchmark and height, the band-range launches of
    each shard count back to back on one card, joined == one whole
    launch; their summed time with the L2 flushed beside the whole
    launch's."""
    import torch

    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.pipelines import ALL
    from repro_torch.pipelines.types import load_types
    out = {}
    for k, name in enumerate(ALL):
        for rows, counts in SHARD_CASES:
            shape = (4, rows, FRAME[1])
            lp, isls = islands(ALL[name](), load_types(name),
                               params.get(name, {}), shape)
            (isl, enc), = isls
            grid = isl.schedule.grid
            bufs = ingest(lp, inputs(name, shape, 300 + 2 * k), dev)
            ins = [bufs[n] for n in isl.inputs]
            whole = K.fused_pipeline(enc, grid, 4)
            want = whole(*ins)
            whole_ms = cold_ms(lambda: whole(*ins), 5, flush)
            row = {"grid": grid, "whole_ms": whole_ms}
            for S in counts:
                n_b = grid // S
                shards = [K.fused_pipeline(enc, grid, 4, bands=(d * n_b, n_b))
                          for d in range(S)]
                parts = [f(*ins) for f in shards]
                for o, w in enumerate(want):
                    joined = torch.cat([p[o] for p in parts], dim=1)
                    if not torch.equal(joined, w):
                        raise AssertionError(
                            f"{name} {rows} rows, {S} ranges joined != one "
                            f"whole launch ({isl.outputs[o]})")
                if name == "usm" and rows == 1080:
                    d = S // 2
                    same(f"fused_band usm range {d} of {S}", parts[d],
                         K.fused_pipeline_reference(
                             enc, grid, 4, bands=(d * n_b, n_b))(*ins))
                row[f"S{S}_ms"] = cold_ms(
                    lambda: [f(*ins) for f in shards], 5, flush)
            out[f"{name}_{rows}"] = row
            print(f"fused_band {name} 4x{rows}x{FRAME[1]} band ranges "
                  f"({card}): grid {grid}; whole launch {whole_ms:.4f} ms, "
                  + ", ".join(f"{S} ranges back to back {row[f'S{S}_ms']:.4f}"
                              f" ms" for S in counts)
                  + " (L2 flushed before each); joined == whole", flush=True)
    return out


def sharded_and_f32(dev, card, params) -> dict:
    """Phase 9: the band grids and their dividing shard counts, the band
    ranges on one card, one USM batch served through the sharded
    executor over every card present (launches counted from 0), the
    executor over all cards against one where there are several, and
    the f32 walk on the card against the host CPU."""
    import numpy as np
    import torch

    from repro_torch.dsl.exec import run_fixed
    from repro_torch.kernels.stencil import kernel as K
    from repro_torch.launch import make_band_mesh
    from repro_torch.lowering import (compile_backend, lower,
                                      partition_islands)
    from repro_torch.pipelines import ALL, hcd, usm
    from repro_torch.pipelines.types import load_types
    from repro_torch.serve import PipelineServer, serve_offline
    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    print(f"sharded phase ({card}): {n_cards} card(s) present", flush=True)
    for name in ALL:
        lp = lower(ALL[name](), load_types(name), params=params.get(name, {}))
        for rows, _ in SHARD_CASES:
            grids = [i.schedule.grid for i in
                     partition_islands(lp, (rows, FRAME[1])).islands]
            print(f"  {name} at {rows}x{FRAME[1]}: island grids {grids}; "
                  f"shard counts 2-8 that divide every grid: "
                  f"{[s for s in range(2, 9) if all(g % s == 0 for g in grids)]}",
                  flush=True)
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    ranges = band_ranges_on_one_card(dev, card, params, flush)
    del flush

    # one served USM batch over every card present, counts from 0
    imgs = [frames(FRAME, 400 + i) for i in range(4)]
    with PipelineServer(usm.build(), load_types("usm"), params["usm"],
                        backend="sharded", batch_size=4) as srv:
        K.LAUNCHES["fused_band"] = 0
        served = serve_offline(srv, imgs)
        launches = K.LAUNCHES["fused_band"]
    assert launches > 0, "the sharded server never launched the kernel"
    want = run_fixed(usm.build(), np.stack(imgs), load_types("usm"),
                     params["usm"], backend="cuda")["masked"].cpu()
    for j, r in enumerate(served):
        if not torch.equal(r["masked"], want[j]):
            raise AssertionError(f"sharded server frame {j} != cuda")
    print(f"served 4 usm {FRAME[0]}x{FRAME[1]} frames through "
          f"PipelineServer(backend='sharded') over {n_cards} card(s) "
          f"({card}): {launches} band-kernel launch(es), all equal to "
          f"backend='cuda'", flush=True)

    if n_cards > 1:
        lp = lower(hcd.build(), load_types("hcd"))
        img = frames((4, 1088, FRAME[1]), 410)
        one = compile_backend(lp, "sharded", mesh=make_band_mesh(1))(img)
        every = compile_backend(lp, "sharded",
                                mesh=make_band_mesh(n_cards))(img)
        for k_ in one:
            if not torch.equal(one[k_], every[k_]):
                raise AssertionError(f"hcd over {n_cards} cards != one card")
        print(f"sharded executor over {n_cards} cards == one card (hcd "
              f"4x1088x{FRAME[1]})", flush=True)
    else:
        print("sharded executor over several cards: only one card was "
              "present", flush=True)

    # the f32 walk on hcd at full size: the card against the host CPU
    img = frames(FRAME, 420)
    t0 = time.perf_counter()
    on_card = run_fixed(hcd.build(), img, load_types("hcd"), backend="f32")
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = run_fixed(hcd.build(), img, load_types("hcd"), backend="f32",
                       device="cpu")
    cpu_s = time.perf_counter() - t0
    for k_, v in on_cpu.items():
        g = on_card[k_].cpu()
        if not (torch.equal(torch.nan_to_num(g), torch.nan_to_num(v))
                and torch.equal(torch.signbit(g), torch.signbit(v))):
            raise AssertionError(f"f32 walk hcd stage {k_}: card != CPU")
    print(f"f32 walk hcd {FRAME[0]}x{FRAME[1]}: card {card_s:.3f} s, host "
          f"CPU {cpu_s:.3f} s, {len(on_cpu)} stages equal", flush=True)

    phase_s = time.perf_counter() - t_phase
    print(f"sharded phase ({card}): {phase_s:.2f} s", flush=True)
    assert phase_s < SHARDED_PHASE_LIMIT_S, \
        f"phase 9 took {phase_s:.1f} s, over {SHARDED_PHASE_LIMIT_S} s"
    return {"cards": n_cards, "ranges": ranges, "served_launches": launches,
            "f32_walk_s": {"card": card_s, "cpu": cpu_s}, "phase_s": phase_s}


# phase 10: qwen3-4b served at full width (src/repro/configs/qwen3_4b.py)
LM_PHASE_LIMIT_S = 60.0
LM_ATOL, LM_RTOL = 0.15, 0.05      # tests/test_serve_elastic.py:33-34


def lm_decode_bytes(cfg) -> int:
    """The least bytes a decode step can move: every weight but the
    embedding read once as bf16 (the port casts each weight's f32 store
    to bf16 on every call, as the reference does, so a step moves about
    4x this)."""
    return (cfg.param_count() - cfg.vocab_padded * cfg.d_model) * 2


def free_card() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def lm_close(label, got, want) -> float:
    """got within (LM_ATOL, LM_RTOL) of want; the top-1 token equal
    wherever want's top-2 margin exceeds twice the tolerance.  The
    largest difference."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    diff = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=LM_ATOL, rtol=LM_RTOL):
        raise AssertionError(f"{label}: logits differ by {diff}")
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 2 * (
        LM_ATOL + LM_RTOL * top2[..., 0].abs())
    if not torch.equal(got.argmax(-1)[clear], want.argmax(-1)[clear]):
        raise AssertionError(f"{label}: the next token differs")
    return diff


def lm_serve_timed(bundle, params, prompts, dev) -> dict:
    """Serve `prompts` (max_new 16) through 4 slots after one warm-up
    step; steps/s, tokens/s, peak memory and the tokens."""
    import torch

    from repro_torch.launch.serve import (ContinuousBatcher, Request,
                                          serve_requests)
    warm = ContinuousBatcher(bundle, params, 4, 64)
    warm.step()
    del warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    batcher = ContinuousBatcher(bundle, params, 4, 64)
    reqs = [Request(i, p, 16) for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    steps = serve_requests(batcher, reqs)
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.generated) for r in reqs)
    return {"steps": steps, "seconds": dt, "steps_per_s": steps / dt,
            "tokens_per_s": n_tok / dt, "tokens": n_tok,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "generated": [r.generated for r in reqs]}


def lm_step_ms(bundle, params, dev, reps: int = 5) -> dict:
    """Time between CUDA events around `reps` decode steps at 4 slots,
    the state carried: the plain step (one launch an op) and the step
    replayed as a CUDA graph (`GraphedDecodeStep`, the batcher's)."""
    import torch

    from repro_torch.launch.serve import GraphedDecodeStep
    out = {}
    for name, step in (("eager_ms", bundle.decode_step),
                       ("graph_ms", GraphedDecodeStep(bundle.decode_step))):
        state = bundle.init_decode_state(4, 64, device=dev)
        tok = torch.zeros(4, dtype=torch.int32, device=dev)
        _, state = step(params, tok, state)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(reps):
            _, state = step(params, tok, state)
        end.record()
        torch.cuda.synchronize(dev)
        out[name] = start.elapsed_time(end) / reps
    return out


def lm_step_trace(bundle, params, dev, card, steps: int = 3,
                  name: str = "lm") -> dict:
    """`steps` graphed decode steps at 4 slots (the batcher's) under
    `torch.profiler`: the window's wall time a step, the device's busy
    share, kernels a step and the five kernels that take the most device
    time (trace in `chiprun_out/<name>_decode_trace.json`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.launch.serve import GraphedDecodeStep
    step = GraphedDecodeStep(bundle.decode_step)
    state = bundle.init_decode_state(4, 64, device=dev)
    tok = torch.zeros(4, dtype=torch.int32, device=dev)
    _, state = step(params, tok, state)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("chip_smoke.decode"):
            for _ in range(steps):
                _, state = step(params, tok, state)
            torch.cuda.synchronize(dev)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / f"{name}_decode_trace.json"
    prof.export_chrome_trace(str(path))
    spans = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("ph") == "X"]
    win, = [(e["ts"], e["ts"] + e["dur"]) for e in spans
            if e["name"] == "chip_smoke.decode"
            and e.get("cat") == "user_annotation"]
    kernels = [e for e in spans if e.get("cat") == "kernel"
               and win[0] <= e["ts"] <= win[1]]
    if not kernels:
        print(f"{name} decode trace ({card}): the profiler recorded no device "
              f"events; busy share not measured", flush=True)
        return {}
    by_name: dict = {}
    for e in kernels:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    wall = (win[1] - win[0]) / 1e3
    busy = busy_ms([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    res = {"wall_ms": wall / steps, "busy_ms": busy / steps,
           "busy_share": busy / wall, "launches": len(kernels) / steps,
           "top_ms": {k[:80]: v / steps for k, v in top}}
    print(f"{name} decode trace ({card}): a step {res['wall_ms']:.3f} ms of "
          f"wall time, device busy {res['busy_ms']:.3f} ms "
          f"({100 * res['busy_share']:.2f}%), {res['launches']:.0f} "
          f"kernels; most device time a step: "
          + "; ".join(f"{k} {v:.3f} ms" for k, v in res["top_ms"].items()),
          flush=True)
    return res


def serve_at_full_width(name, bundle, params, bound_ms, dev, card,
                        state: str = "bf16 KV") -> dict:
    """Phase 10's serving measurement on another model (phases 11-13):
    the 8 requests on 4 slots through the batcher's graphed step
    (steps/s, tokens/s, peak memory), the step graphed and plain between
    CUDA events, a traced graphed step."""
    import numpy as np
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, bundle.cfg.vocab_size, size=4))
               for _ in range(8)]
    r = lm_serve_timed(bundle, params, prompts, dev)
    r.update(lm_step_ms(bundle, params, dev))
    r["trace"] = lm_step_trace(bundle, params, dev, card, name=name)
    r["bound_ms"] = bound_ms
    r.pop("generated")
    print(f"{name} ({card}): served 8 requests, {state}: {r['steps']} "
          f"decode steps in {r['seconds']:.3f} s, {r['steps_per_s']:.2f} "
          f"steps/s, {r['tokens_per_s']:.2f} tokens/s; a step between CUDA "
          f"events: graphed {r['graph_ms']:.3f} ms "
          f"({r['graph_ms'] / bound_ms:.2f}x the {bound_ms:.3f} ms bound), "
          f"plain {r['eager_ms']:.3f} ms; peak {r['peak_gb']:.2f} GB",
          flush=True)
    return r


def lm_serving(dev, card) -> dict:
    """Phase 10: qwen3-4b at full width on the card (docstring item
    10)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.launch.serve import GraphedDecodeStep
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.quant.autoquant import autoquant, fake_quant_params
    from repro_torch.quant.calibrate import REVERSE_TOPO_CLASSES
    from repro_torch.serve.prefill import prefill
    free_card()
    t_phase = time.perf_counter()
    cfg = get_config("qwen3-4b")
    bundles = {kv: get_model(dataclasses.replace(cfg, kv_cache_dtype=kv))
               for kv in ("bf16", "int8")}
    params = bundles["bf16"].init_params(
        torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    bound_ms = lm_decode_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    print(f"lm ({card}): qwen3-4b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_padded}, {n_params / 1e9:.3f} G "
          f"parameters in f32 on the card; a decode step's bytes bound "
          f"{bound_ms:.3f} ms", flush=True)
    out = {"params": n_params, "bound_ms": bound_ms, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now

    # (a) 8 requests, 4 slots, bf16 and int8 caches
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=4))
               for _ in range(8)]
    for kv, b in bundles.items():
        r = lm_serve_timed(b, params, prompts, dev)
        r.update(lm_step_ms(b, params, dev))
        r["trace"] = lm_step_trace(b, params, dev, card)
        out[f"serve_{kv}"] = r
        print(f"lm ({card}): served 8 requests, {kv} KV: {r['steps']} "
              f"decode steps in {r['seconds']:.3f} s, "
              f"{r['steps_per_s']:.2f} steps/s, {r['tokens_per_s']:.2f} "
              f"tokens/s; a step between CUDA events: graphed "
              f"{r['graph_ms']:.3f} ms ({r['graph_ms'] / bound_ms:.2f}x the "
              f"bound), plain {r['eager_ms']:.3f} ms; peak "
              f"{r['peak_gb']:.2f} GB", flush=True)
    pairs = [(a, b) for ra, rb in zip(out["serve_bf16"]["generated"],
                                      out["serve_int8"]["generated"])
             for a, b in zip(ra, rb)]
    out["kv_agreement"] = float(np.mean([a == b for a, b in pairs]))
    print(f"lm ({card}): int8 KV against bf16 KV, generated-token "
          f"agreement {out['kv_agreement']:.4f}", flush=True)
    part("a")

    # (b) fused prefill of 128 tokens against 128 decode steps
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32)).to(dev)
    b = bundles["bf16"]
    state = b.init_decode_state(1, 136, device=dev)
    step = GraphedDecodeStep(b.decode_step)
    for t in range(128):
        step_logits, state = step(params, toks[:, t], state)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pf_logits, pf_state = prefill(params, toks, cfg, 136)
    torch.cuda.synchronize(dev)
    out["prefill_s"] = time.perf_counter() - t0
    out["prefill_max_diff"] = lm_close("prefill vs 128 decode steps",
                                       pf_logits, step_logits)
    nxt = step_logits.argmax(-1).to(torch.int32)
    if not torch.equal(b.decode_step(params, nxt, state)[0].argmax(-1),
                       b.decode_step(params, nxt, pf_state)[0].argmax(-1)):
        raise AssertionError("prefill: the next step's token differs")
    print(f"lm ({card}): fused prefill of 128 tokens in "
          f"{out['prefill_s']:.3f} s, against 128 decode steps: largest "
          f"logit difference {out['prefill_max_diff']:.5f}, next token "
          f"equal", flush=True)
    del state, pf_state
    part("b")

    # (c) the card against the host CPU, 2 layers, the same weights
    cut = dataclasses.replace(cfg, n_layers=2)
    p2 = dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"]))
    p2_cpu = tree_map(lambda t: t.cpu(), p2)
    batch = make_batch(cut, 2, 16, seed=2, device=dev)
    t0 = time.perf_counter()
    diffs = {"forward": lm_close(
        "forward, card vs host CPU",
        get_model(cut).forward(p2, batch),
        get_model(cut).forward(p2_cpu, tree_map(lambda t: t.cpu(), batch)))}
    for kv in ("bf16", "int8"):
        m = get_model(dataclasses.replace(cut, kv_cache_dtype=kv))
        s_gpu = m.init_decode_state(2, 16, device=dev)
        s_cpu = m.init_decode_state(2, 16, device="cpu")
        d = 0.0
        for t in range(4):
            got, s_gpu = m.decode_step(p2, batch["tokens"][:, t], s_gpu)
            want, s_cpu = m.decode_step(p2_cpu, batch["tokens"][:, t].cpu(),
                                        s_cpu)
            d = max(d, lm_close(f"decode {kv}, card vs host CPU", got, want))
        diffs[f"decode_{kv}"] = d
    out["card_vs_cpu"] = diffs
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    print(f"lm ({card}): 2 layers at full width, card against host CPU: "
          f"largest logit differences {diffs} ({out['card_vs_cpu_s']:.2f} s)",
          flush=True)
    del p2, p2_cpu
    part("c")

    # (d) 8-bit weights served, then AutoQuant on 2 probe batches of 2x16
    q8 = fake_quant_params(params, {c: 8 for c in REVERSE_TOPO_CLASSES})
    r = lm_serve_timed(bundles["bf16"], q8, prompts, dev)
    del q8
    pairs = [(a, c) for ra, rc in zip(out["serve_bf16"]["generated"],
                                      r["generated"]) for a, c in zip(ra, rc)]
    out["quant8_agreement"] = float(np.mean([a == c for a, c in pairs]))
    print(f"lm ({card}): 8-bit weights served at {r['tokens_per_s']:.2f} "
          f"tokens/s; generated-token agreement with bf16 weights "
          f"{out['quant8_agreement']:.4f}", flush=True)
    free_card()
    probes = [make_batch(cfg, 2, 16, seed=s, device=dev) for s in range(2)]
    t0 = time.perf_counter()
    res = autoquant(bundles["bf16"], params, probes, target_agreement=0.97)
    torch.cuda.synchronize(dev)
    out["autoquant"] = {"bits": res.bits, "profile_passes":
                        res.profile_passes, "uniform_bits": res.uniform_bits,
                        "quality": res.quality, "bytes_ratio": res.bytes_ratio,
                        "seconds": time.perf_counter() - t0}
    print(f"lm ({card}): autoquant at full width: bits {res.bits}, "
          f"{res.profile_passes} profile passes, quality {res.quality:.4f}, "
          f"{out['autoquant']['seconds']:.2f} s", flush=True)
    del params
    free_card()
    part("d")
    for k in ("serve_bf16", "serve_int8"):
        out[k].pop("generated")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"lm phase ({card}): {out['phase_s']:.2f} s (parts: "
          + ", ".join(f"({k}) {v:.2f} s" for k, v in out["part_s"].items())
          + ")", flush=True)
    assert out["phase_s"] < LM_PHASE_LIMIT_S, \
        f"phase 10 took {out['phase_s']:.1f} s, over {LM_PHASE_LIMIT_S} s"
    print(json.dumps({"lm_serving": out}), flush=True)
    return out


# phase 11: qwen2-moe-a2.7b served at full width
# (src/repro/configs/qwen2_moe_a2_7b.py)
MOE_PHASE_LIMIT_S = 120.0


def with_routes(fn):
    """fn() with the experts each MoE layer picks recorded: the result
    and one (tokens, k) tensor of sorted expert ids a layer call, on the
    host."""
    from repro_torch.models import blocks, moe
    seen = []
    orig = blocks.moe_ffn

    def spy(x, p, cfg):
        _, _, top_e = moe.route(x.reshape(-1, x.shape[-1]), p["router"],
                                cfg)
        seen.append(top_e.sort(-1).values.cpu())
        return orig(x, p, cfg)
    blocks.moe_ffn = spy
    try:
        return fn(), seen
    finally:
        blocks.moe_ffn = orig


def routes_alike(a, b):
    """Per layer call and token, whether the token's expert set is the
    same in both records: (layer calls, tokens) booleans."""
    import torch
    return torch.stack([(x == y).all(-1) for x, y in zip(a, b)])


def host_copy(params, f32_leaves=()):
    """The parameters on the host: each matrix in bf16, the values every
    use of it rounds to first (`common.matmul_f32`, `moe._bmm_f32`, the
    embedding gather), so the CPU computes what it would from the f32
    store; the norm weights and the leaves named in `f32_leaves`, read
    in f32, in f32."""
    import torch

    from repro_torch.models.common import tree_map

    def leaf(path, t):
        f32 = path[-1].startswith("ln_") or "norm" in path[-1] \
            or path[-1] in f32_leaves
        return t.cpu() if f32 else t.to(torch.bfloat16).cpu()
    return tree_map(leaf, params, with_path=True)


def moe_close(label, got, want, clean) -> tuple:
    """`lm_close` on every token, or, where that fails and some tokens
    saw other routes on the card than on the host, on the `clean` ones
    (routed alike, and so was every token before them in their
    sequence, whose keys and values they read); the failure stands if
    those differ too.  The largest difference and the tokens left
    out."""
    try:
        return lm_close(label, got, want), 0
    except AssertionError:
        if bool(clean.all()):
            raise
    return (lm_close(f"{label} (tokens routed alike)", got[clean.to(
        got.device)], want[clean.to(want.device)]), int((~clean).sum()))


def moe_serving(dev, card) -> dict:
    """Phase 11: qwen2-moe-a2.7b at full width on the card (docstring
    item 11)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.moe import capacity
    from repro_torch.models.registry import get_model
    from repro_torch.serve.prefill import prefill
    free_card()
    t_phase = time.perf_counter()
    cfg = get_config("qwen2-moe-a2.7b")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    bound_ms = lm_decode_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    print(f"moe ({card}): qwen2-moe-a2.7b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k} of "
          f"d_ff {cfg.moe_d_ff} and a shared expert of {cfg.shared_expert_d_ff}, "
          f"vocab {cfg.vocab_padded}, {n_params / 1e9:.3f} G parameters in "
          f"f32 on the card ({torch.cuda.memory_allocated(dev) / 1e9:.2f} "
          f"GB); a decode step's bytes bound {bound_ms:.3f} ms", flush=True)
    out = {"params": n_params, "bound_ms": bound_ms, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now

    # (a) 8 requests, 4 slots, bf16 KV, through the batcher's graphed step
    out["serve_bf16"] = serve_at_full_width("moe", bundle, params, bound_ms,
                                            dev, card)
    part("a")

    # (b) fused prefill of 128 tokens on the card and on the host CPU
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    (pf_gpu, _), r_gpu = with_routes(
        lambda: prefill(params, toks.to(dev), cfg, 136))
    torch.cuda.synchronize(dev)
    out["prefill_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_cpu = host_copy(params)
    out["to_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    (pf_cpu, _), r_cpu = with_routes(
        lambda: prefill(params_cpu, toks, cfg, 136))
    out["prefill_cpu_s"] = time.perf_counter() - t0
    alike = routes_alike(r_gpu, r_cpu)
    out["prefill_routes_alike"] = {
        "token_layers": float(alike.float().mean()),
        "tokens_all_layers": float(alike.all(0).float().mean())}
    out["prefill_max_diff"] = lm_close("moe prefill, card vs host CPU",
                                       pf_gpu, pf_cpu)
    print(f"moe ({card}): fused prefill of 128 tokens (capacity "
          f"{capacity(cfg, 128)} an expert), card "
          f"{out['prefill_s']:.3f} s, host CPU {out['prefill_cpu_s']:.2f} s "
          f"(weights copied to the host in {out['to_host_s']:.2f} s); "
          f"routed alike: {out['prefill_routes_alike']} (token-layers, "
          f"tokens in all {cfg.n_layers} layers); largest next-token "
          f"logit difference {out['prefill_max_diff']:.5f}", flush=True)
    part("b")

    # (c) the card against the host CPU, 2 layers, the same weights
    cut = dataclasses.replace(cfg, n_layers=2)
    m = get_model(cut)
    p2 = dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"]))
    p2_cpu = dict(params_cpu,
                  blocks=tree_map(lambda t: t[:2], params_cpu["blocks"]))
    batch = make_batch(cut, 2, 16, seed=2, device="cpu")
    t0 = time.perf_counter()
    got, r_gpu = with_routes(lambda: m.forward(p2, tree_map(
        lambda t: t.to(dev), batch)))
    want, r_cpu = with_routes(lambda: m.forward(p2_cpu, batch))
    alike = [routes_alike(r_gpu, r_cpu)]
    routed = alike[0].all(0).reshape(2, 16)
    clean = routed.int().cumprod(1).bool()
    diffs, left_out = {}, {}
    diffs["forward"], left_out["forward"] = moe_close(
        "moe forward, card vs host CPU", got, want, clean)
    s_gpu = m.init_decode_state(2, 16, device=dev)
    s_cpu = m.init_decode_state(2, 16, device="cpu")
    d, n = 0.0, 0
    clean = torch.ones(2, dtype=torch.bool)
    for t in range(4):
        tok = batch["tokens"][:, t]
        (got, s_gpu), r_gpu = with_routes(
            lambda: m.decode_step(p2, tok.to(dev), s_gpu))
        (want, s_cpu), r_cpu = with_routes(
            lambda: m.decode_step(p2_cpu, tok, s_cpu))
        alike.append(routes_alike(r_gpu, r_cpu))
        clean &= alike[-1].all(0)
        dt, nt = moe_close(f"moe decode step {t}, card vs host CPU", got,
                           want, clean)
        d, n = max(d, dt), n + nt
    diffs["decode_bf16"], left_out["decode_bf16"] = d, n
    out["card_vs_cpu"] = diffs
    out["card_vs_cpu_left_out"] = left_out
    alike = torch.cat(alike, dim=1)
    out["routes_alike"] = {
        "by_layer": [float(a) for a in alike.float().mean(1)],
        "tokens_both_layers": float(alike.all(0).float().mean())}
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    print(f"moe ({card}): 2 layers at full width, card against host CPU: "
          f"routed alike {out['routes_alike']} (forward 32 tokens and 4 "
          f"decode steps of 2); largest logit differences {diffs}, tokens "
          f"left out {left_out} ({out['card_vs_cpu_s']:.2f} s)", flush=True)
    del p2, p2_cpu, params_cpu, params, s_gpu
    free_card()
    part("c")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"moe phase ({card}): {out['phase_s']:.2f} s (parts: "
          + ", ".join(f"({k}) {v:.2f} s" for k, v in out["part_s"].items())
          + ")", flush=True)
    assert out["phase_s"] < MOE_PHASE_LIMIT_S, \
        f"phase 11 took {out['phase_s']:.1f} s, over {MOE_PHASE_LIMIT_S} s"
    print(json.dumps({"moe_serving": out}), flush=True)
    return out


# phase 12: paligemma-3b and whisper-medium served at full width
# (src/repro/configs/paligemma_3b.py, src/repro/configs/whisper_medium.py)
VLM_ENCDEC_PHASE_LIMIT_S = 120.0
# tests/test_encdec_vlm.py:36-37: stepwise decode against decode_train
ENCDEC_ATOL, ENCDEC_RTOL, ENCDEC_AGREE = 0.2, 0.05, 0.85
# tests/test_encdec_vlm.py:80: the image prefix moves the suffix logits
IMAGE_MIN_CHANGE = 1e-3


def encdec_decode_bytes(cfg, slots: int) -> int:
    """The least bytes a whisper decode step at `slots` moves: the
    decoder weights it reads (self-attention, the cross-attention's
    query and output projections, the MLP) and the unembedding once as
    bf16, and every slot's cross K/V (bf16) once.  The cross-attention's
    K and V projections are read by `cross_kv` only."""
    D, F, L, hd = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.hd
    H, KV, T = cfg.n_heads, cfg.n_kv_heads, cfg.encoder_seq
    attn = 2 * D * H * hd + 2 * D * KV * hd
    weights = L * (attn + 2 * D * H * hd + 3 * D * F) + D * cfg.vocab_padded
    return (weights + 2 * L * slots * KV * T * hd) * 2


def all_close(label, got, want, atol, rtol) -> float:
    """got within (atol, rtol) of want, on the host; the largest
    difference."""
    import torch
    got, want = got.float().cpu(), want.float().cpu()
    diff = float((got - want).abs().max())
    if not torch.allclose(got, want, atol=atol, rtol=rtol):
        raise AssertionError(f"{label}: values differ by {diff}")
    return diff


def vlm_at_full_width(dev, card) -> dict:
    """Phase 12 (a): paligemma-3b (docstring item 12)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.registry import get_model
    cfg = get_config("paligemma-3b")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    assert n_params == cfg.param_count() + 2 * cfg.n_layers * cfg.d_model \
        + cfg.d_model, "paligemma-3b: the tree is not the config's size"
    bound_ms = lm_decode_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    print(f"vlm ({card}): paligemma-3b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads} KV head "
          f"of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}, "
          f"{cfg.n_image_tokens} image tokens; {n_params / 1e9:.3f} G "
          f"parameters, {4 * n_params / 1e9:.2f} GB in f32 on the card "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)",
          flush=True)
    out = {"params": n_params, "serve_bf16": serve_at_full_width(
        "vlm", bundle, params, bound_ms, dev, card)}

    # one image (256 patch embeddings) and 128 text tokens, on the card
    S = cfg.n_image_tokens + 128
    batch = make_batch(cfg, 1, S, seed=3, device=dev)
    zero = dict(batch, patch_embeds=torch.zeros_like(batch["patch_embeds"]))
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with_img = bundle.forward(params, batch)
    torch.cuda.synchronize(dev)
    out["image_forward_s"] = time.perf_counter() - t0
    without = bundle.forward(params, zero)
    n = cfg.n_image_tokens
    assert with_img.shape == (1, S, cfg.vocab_padded)
    assert bool(torch.isfinite(with_img).all())
    out["image_suffix_change"] = float(
        (with_img[:, n:] - without[:, n:]).abs().max())
    if not out["image_suffix_change"] > IMAGE_MIN_CHANGE:
        raise AssertionError(f"vlm: zeroing the image moves the suffix "
                             f"logits by {out['image_suffix_change']}")
    print(f"vlm ({card}): forward of 1 image ({n} patch embeddings) and "
          f"128 text tokens in {out['image_forward_s']:.3f} s; zeroing the "
          f"patch embeddings moves the suffix logits by up to "
          f"{out['image_suffix_change']:.5f} (> {IMAGE_MIN_CHANGE})",
          flush=True)
    del with_img, without

    # the card against the host CPU, 2 layers, the same weights
    cut = dataclasses.replace(cfg, n_layers=2)
    m = get_model(cut)
    p2 = dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"]))
    p2_cpu = host_copy(p2)
    t0 = time.perf_counter()
    diffs = {"forward": lm_close(
        "vlm forward, card vs host CPU", m.forward(p2, batch),
        m.forward(p2_cpu, tree_map(lambda t: t.cpu(), batch)))}
    s_gpu = m.init_decode_state(1, 16, device=dev)
    s_cpu = m.init_decode_state(1, 16, device="cpu")
    d = 0.0
    for t in range(4):
        tok = batch["tokens"][:, n + t]
        got, s_gpu = m.decode_step(p2, tok, s_gpu)
        want, s_cpu = m.decode_step(p2_cpu, tok.cpu(), s_cpu)
        d = max(d, lm_close(f"vlm decode step {t}, card vs host CPU", got,
                            want))
    diffs["decode_bf16"] = d
    out["card_vs_cpu"] = diffs
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    print(f"vlm ({card}): 2 layers at full width, card against host CPU "
          f"(the image forward and 4 decode steps): largest logit "
          f"differences {diffs} ({out['card_vs_cpu_s']:.2f} s)", flush=True)
    del params, p2, p2_cpu, s_gpu, batch, zero
    free_card()
    return out


def encdec_at_full_width(dev, card) -> dict:
    """Phase 12 (b): whisper-medium (docstring item 12)."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.models import encdec
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.registry import get_model
    cfg = get_config("whisper-medium")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    bound_ms = encdec_decode_bytes(cfg, 4) / HBM_BYTES_PER_S * 1e3
    print(f"encdec ({card}): whisper-medium, {cfg.n_encoder_layers} "
          f"encoder and {cfg.n_layers} decoder layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_padded}, {cfg.encoder_seq} frames; {n_params / 1e9:.4f}"
          f" G parameters, {4 * n_params / 1e9:.2f} GB in f32 on the card "
          f"({torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated)",
          flush=True)
    out = {"params": n_params}

    # encode 1500 frames, then 16 decode steps over its cross K/V against
    # decode_train (the reference test's check at full width)
    batch = make_batch(cfg, 1, 16, seed=9, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    enc = encdec.encode(params, batch["frames"], cfg)
    torch.cuda.synchronize(dev)
    out["encode_s"] = time.perf_counter() - t0
    assert enc.shape == (1, cfg.encoder_seq, cfg.d_model)
    assert bool(torch.isfinite(enc).all())
    full = encdec.decode_train(params, batch["tokens"], enc, cfg)
    ck, cv = encdec.cross_kv(params, enc, cfg)
    state = dict(bundle.init_decode_state(1, 32, device=dev), cross_k=ck,
                 cross_v=cv)
    steps = []
    for t in range(16):
        logits, state = bundle.decode_step(params, batch["tokens"][:, t],
                                           state)
        steps.append(logits)
    dec = torch.stack(steps, dim=1)
    out["decode_vs_decode_train"] = all_close(
        "whisper decode vs decode_train", dec, full, ENCDEC_ATOL,
        ENCDEC_RTOL)
    out["argmax_agreement"] = float(
        (dec.argmax(-1) == full.argmax(-1)).float().mean())
    if out["argmax_agreement"] < ENCDEC_AGREE:
        raise AssertionError(f"whisper decode vs decode_train: argmax "
                             f"agreement {out['argmax_agreement']}")
    print(f"encdec ({card}): encoded {cfg.encoder_seq} frames in "
          f"{out['encode_s']:.3f} s; 16 decode steps over its cross K/V "
          f"against decode_train: largest logit difference "
          f"{out['decode_vs_decode_train']:.5f} (atol {ENCDEC_ATOL}, rtol "
          f"{ENCDEC_RTOL}), argmax agreement {out['argmax_agreement']:.4f}",
          flush=True)
    del enc, full, ck, cv, state, dec, steps

    out["serve_bf16"] = serve_at_full_width("encdec", bundle, params,
                                            bound_ms, dev, card)

    # the card against the host CPU, 2 encoder and 2 decoder layers
    cut = dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2)
    m = get_model(cut)
    p2 = dict(params, **{k: tree_map(lambda t: t[:2], params[k])
                         for k in ("enc_blocks", "dec_blocks")})
    p2_cpu = host_copy(p2)
    cpu_batch = tree_map(lambda t: t.cpu(), batch)
    t0 = time.perf_counter()
    enc_gpu = encdec.encode(p2, batch["frames"], cut)
    enc_cpu = encdec.encode(p2_cpu, cpu_batch["frames"], cut)
    diffs = {"encode": all_close("whisper encode, card vs host CPU",
                                 enc_gpu, enc_cpu, LM_ATOL, LM_RTOL)}
    s_gpu = dict(m.init_decode_state(1, 16, device=dev),
                 **dict(zip(("cross_k", "cross_v"),
                            encdec.cross_kv(p2, enc_gpu, cut))))
    s_cpu = dict(m.init_decode_state(1, 16, device="cpu"),
                 **dict(zip(("cross_k", "cross_v"),
                            encdec.cross_kv(p2_cpu, enc_cpu, cut))))
    d = 0.0
    for t in range(4):
        got, s_gpu = m.decode_step(p2, batch["tokens"][:, t], s_gpu)
        want, s_cpu = m.decode_step(p2_cpu, cpu_batch["tokens"][:, t], s_cpu)
        d = max(d, lm_close(f"whisper decode step {t}, card vs host CPU",
                            got, want))
    diffs["decode_bf16"] = d
    out["card_vs_cpu"] = diffs
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    print(f"encdec ({card}): 2 encoder and 2 decoder layers at full width, "
          f"card against host CPU: largest differences {diffs} (encoder "
          f"output, then logits of 4 decode steps; "
          f"{out['card_vs_cpu_s']:.2f} s)", flush=True)
    del params, p2, p2_cpu, s_gpu, enc_gpu, batch
    free_card()
    return out


def vlm_encdec_serving(dev, card) -> dict:
    """Phase 12: paligemma-3b and whisper-medium at full width on the
    card (docstring item 12)."""
    free_card()
    t_phase = time.perf_counter()
    out = {"paligemma-3b": vlm_at_full_width(dev, card)}
    out["part_s"] = {"a": time.perf_counter() - t_phase}
    out["whisper-medium"] = encdec_at_full_width(dev, card)
    out["phase_s"] = time.perf_counter() - t_phase
    out["part_s"]["b"] = out["phase_s"] - out["part_s"]["a"]
    print(f"vlm and encdec phase ({card}): {out['phase_s']:.2f} s (parts: "
          + ", ".join(f"({k}) {v:.2f} s" for k, v in out["part_s"].items())
          + ")", flush=True)
    assert out["phase_s"] < VLM_ENCDEC_PHASE_LIMIT_S, \
        f"phase 12 took {out['phase_s']:.1f} s, over " \
        f"{VLM_ENCDEC_PHASE_LIMIT_S} s"
    print(json.dumps({"vlm_encdec_serving": out}), flush=True)
    return out


# phase 13: rwkv6-3b served at full width (src/repro/configs/rwkv6_3b.py)
RWKV_PHASE_LIMIT_S = 60.0
# the RWKV6 leaves a use reads in f32 (`blocks._rwkv_decay`, the bonus u,
# `rms_norm`'s weights and ln_x); every other matrix is rounded to bf16
# first, the mixes' mu too
RWKV_F32_LEAVES = ("w_lora_a", "w_lora_b", "w0", "u", "ln1", "ln2")


def rwkv_decode_bytes(params, slots: int) -> int:
    """The least bytes an rwkv decode step at `slots` moves, from the
    parameter tree: every weight but the embedding read once as bf16,
    and the state (the f32 WKV state, the bf16 carried tokens) read and
    written once.  `lm_decode_bytes` counts the config's
    `param_count()`, whose 4 D^2 + 3 D F a layer is not the block's
    6 D^2 + 2 D F + 2 D 64."""
    from repro_torch.models.common import tree_items
    weights = sum(t.numel() for p, t in tree_items(params)
                  if p[0] != "embed")
    L, H, K = params["blocks"]["tmix"]["u"].shape
    D = params["blocks"]["ln1"].shape[1]
    state = slots * L * (H * K * K * 4 + 2 * D * 2)
    return weights * 2 + 2 * state


def max_diff(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max())


def rwkv_prefill_and_decode(bundle, params, step, toks, dev):
    """`toks` (1, T) fed to `step` one at a time from an empty state, then
    to `prefill`: the last step's logits and state, the prefill's, and
    the prefill's seconds."""
    import torch

    from repro_torch.serve.prefill import prefill
    T = toks.shape[1]
    state = bundle.init_decode_state(1, T + 8, device=dev)
    for t in range(T):
        logits, state = step(params, toks[:, t].to(dev), state)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    pf, pf_state = prefill(params, toks.to(dev), bundle.cfg, T + 8)
    torch.cuda.synchronize(dev)
    return logits, state, pf, pf_state, time.perf_counter() - t0


def rwkv_prefill_drift(dev, card) -> None:
    """Not a phase (call it from `python -c` on a machine with a card):
    rwkv6-3b at full width cut to 1-32 layers, prefill against 8 and 128
    decode steps, beside the rounding noise of one algorithm (the
    prefill of a batch of 1 against the same row in a batch of 2)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.common import tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.serve.prefill import prefill
    cfg = get_config("rwkv6-3b")
    params = get_model(cfg).init_params(
        torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32))
    for L in (1, 2, 4, 8, 16, 32):
        m = get_model(dataclasses.replace(cfg, n_layers=L))
        p = dict(params, blocks=tree_map(lambda t: t[:L], params["blocks"]))
        for T in (8, 128):
            lg, st, pf, ps, _ = rwkv_prefill_and_decode(
                m, p, m.decode_step, toks[:, :T], dev)
            pf2, _ = prefill(p, toks[:, :T].repeat(2, 1).to(dev), m.cfg,
                             T + 8)
            s_apart = max_diff(ps["s"], st["s"]) / float(st["s"].abs().max())
            print(f"rwkv drift ({card}): {L} layers, {T} tokens: prefill "
                  f"vs decode {max_diff(pf, lg):.5f}, prefill batch 1 vs "
                  f"2 {max_diff(pf, pf2[:1]):.5f}, largest logit "
                  f"{float(lg.abs().max()):.3f}, next token equal "
                  f"{bool(torch.equal(pf.argmax(-1), lg.argmax(-1)))}, "
                  f"WKV state apart by {s_apart:.5f} of its largest",
                  flush=True)


# a layer on the card and on the host CPU from the same input and state:
# output and WKV state apart by at most this share of their largest
# magnitude (two bf16 units; a unit apart seen)
RWKV_LAYER_TOL = 2.0 ** -6


def rwkv_layers_on_both(p, p_cpu, cfg, x, state) -> tuple:
    """Each layer of `p` (on the card) and of `p_cpu` (on the host CPU)
    from the card's input x (B, T, D), chunked from zeros where `state`
    is None, else a token from the card's state: outputs and WKV states
    within RWKV_LAYER_TOL, then the logits from the card's last hidden
    state within phase 10's tolerance.  The card's new state, and (the
    largest relative difference, the largest logit difference)."""
    import torch

    from repro_torch.models import blocks, lm
    from repro_torch.models.common import _scalar, dense, rms_norm
    rel, new = 0.0, {"s": [], "x_att": [], "x_ffn": []}
    for layer in range(cfg.n_layers):
        st = None if state is None else {k: state[k][layer] for k in new}
        y, s_new = blocks.rwkv_fwd(x, lm.layer_params(p["blocks"], layer),
                                   cfg, st, chunked=state is None)
        y_cpu, s_cpu = blocks.rwkv_fwd(
            x.cpu(), lm.layer_params(p_cpu["blocks"], layer), cfg,
            None if st is None else {k: v.cpu() for k, v in st.items()},
            chunked=state is None)
        for label, g, w in (("output", y, y_cpu),
                            ("WKV state", s_new["s"], s_cpu["s"])):
            r = max_diff(g, w) / float(w.float().abs().max())
            if r > RWKV_LAYER_TOL:
                raise AssertionError(f"rwkv layer {layer} {label}, card vs "
                                     f"host CPU: apart by {r} of its largest")
            rel = max(rel, r)
        for k in new:
            new[k].append(s_new[k])
        x = y

    def head(q, h):
        h = rms_norm(h, q["final_norm"], cfg.norm_eps)
        return dense(h, q["unembed"]).float() * _scalar(cfg.logit_scale,
                                                        torch.float32)
    d = lm_close("rwkv logits from the card's last hidden state, card vs "
                 "host CPU", head(p, x), head(p_cpu, x.cpu()))
    new = {k: torch.stack(v) for k, v in new.items()}
    if state is not None:
        new["length"] = state["length"] + 1
    return new, (rel, d)


def rwkv_serving(dev, card) -> dict:
    """Phase 13: rwkv6-3b at full width on the card (docstring item
    13)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.batches import make_batch
    from repro_torch.launch.serve import GraphedDecodeStep
    from repro_torch.models import lm
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.models.registry import get_model
    from repro_torch.serve.prefill import prefill
    free_card()
    t_phase = time.perf_counter()
    cfg = get_config("rwkv6-3b")
    bundle = get_model(cfg)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t.numel() for _, t in tree_items(params))
    bound_ms = lm_decode_bytes(cfg) / HBM_BYTES_PER_S * 1e3
    tree_bound_ms = rwkv_decode_bytes(params, 4) / HBM_BYTES_PER_S * 1e3
    print(f"rwkv ({card}): rwkv6-3b, {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_padded}; "
          f"{n_params / 1e9:.3f} G parameters, {4 * n_params / 1e9:.2f} GB "
          f"in f32 on the card ({torch.cuda.memory_allocated(dev) / 1e9:.2f} "
          f"GB allocated); a decode step's bytes bound {bound_ms:.3f} ms "
          f"(param_count), {tree_bound_ms:.3f} ms (the tree and the state "
          f"at 4 slots)", flush=True)
    out = {"params": n_params, "bound_ms": bound_ms,
           "tree_bound_ms": tree_bound_ms, "part_s": {}}
    t_part = time.perf_counter()

    def part(name):
        nonlocal t_part
        now = time.perf_counter()
        out["part_s"][name] = now - t_part
        t_part = now

    # (a) 8 requests, 4 slots, through the batcher's graphed step
    out["serve"] = serve_at_full_width("rwkv", bundle, params, bound_ms,
                                       dev, card, "recurrent state")
    part("a")

    # (b) prefill_recurrent of 128 tokens against 128 decode steps: at
    # the reference test's depth (its smoke config's 2 layers, here at
    # full width) within its tolerance; at full depth, where bf16
    # rounding noise grows layer by layer on random weights
    # (`rwkv_prefill_drift`), the next token equal, the difference
    # printed beside the same prefill's on the card and the host CPU
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 128)).astype(np.int32))
    cut = dataclasses.replace(cfg, n_layers=2)
    m = get_model(cut)
    p2 = dict(params, blocks=tree_map(lambda t: t[:2], params["blocks"]))
    lg2, st2, pf2, pst2, _ = rwkv_prefill_and_decode(m, p2, m.decode_step,
                                                     toks, dev)
    out["prefill_2_layers_max_diff"] = lm_close(
        "rwkv prefill vs 128 decode steps, 2 layers", pf2, lg2)
    nxt = lg2.argmax(-1).to(torch.int32)
    if not torch.equal(m.decode_step(p2, nxt, st2)[0].argmax(-1),
                       m.decode_step(p2, nxt, pst2)[0].argmax(-1)):
        raise AssertionError("rwkv prefill, 2 layers: the next step's "
                             "token differs")
    del st2, pst2
    lg, _, pf, _, out["prefill_s"] = rwkv_prefill_and_decode(
        bundle, params, GraphedDecodeStep(bundle.decode_step), toks, dev)
    t0 = time.perf_counter()
    params_cpu = host_copy(params, RWKV_F32_LEAVES)
    out["to_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_logits, _ = prefill(params_cpu, toks, cfg, 136)
    out["prefill_cpu_s"] = time.perf_counter() - t0
    out["prefill_max_diff"] = max_diff(pf, lg)
    out["prefill_card_vs_cpu"] = max_diff(pf, cpu_logits)
    top2 = lg.float().topk(2, dim=-1).values[0]
    out["decode_top2_margin"] = float(top2[0] - top2[1])
    out["card_vs_cpu_token_equal"] = bool(torch.equal(
        pf.argmax(-1).cpu(), cpu_logits.argmax(-1)))
    print(f"rwkv ({card}): prefill_recurrent of 128 tokens, card "
          f"{out['prefill_s']:.3f} s, host CPU {out['prefill_cpu_s']:.2f} s "
          f"(weights copied to the host in {out['to_host_s']:.2f} s); "
          f"largest logit difference against 128 decode steps at 2 layers "
          f"{out['prefill_2_layers_max_diff']:.5f} (next token equal), at "
          f"{cfg.n_layers} layers {out['prefill_max_diff']:.5f}; the "
          f"{cfg.n_layers}-layer prefill card against host CPU "
          f"{out['prefill_card_vs_cpu']:.5f} (next token equal: "
          f"{out['card_vs_cpu_token_equal']}); the decode's top-2 margin "
          f"{out['decode_top2_margin']:.5f}", flush=True)
    assert bool(torch.isfinite(pf).all()) and pf.shape == lg.shape
    if not torch.equal(pf.argmax(-1), lg.argmax(-1)):
        raise AssertionError("rwkv prefill: the next token differs from "
                             "128 decode steps'")
    part("b")

    # (c) the card against the host CPU at 2 layers, the same weights:
    # layer by layer from the card's inputs and states (gated), and end
    # to end (printed: a bf16 rounding a unit apart compounds from layer
    # to layer on random weights, so the ends part further)
    p2_cpu = dict(params_cpu,
                  blocks=tree_map(lambda t: t[:2], params_cpu["blocks"]))
    tokens = make_batch(cut, 2, 16, seed=2, device="cpu")["tokens"]
    t0 = time.perf_counter()
    gate = {"forward": rwkv_layers_on_both(
        p2, p2_cpu, cut, lm._embed(p2, tokens.to(dev), cut), None)[1]}
    state = m.init_decode_state(2, 16, device=dev)
    for t in range(4):
        x = lm._embed(p2, tokens[:, t:t + 1].to(dev), cut)
        state, gate[f"decode_{t}"] = rwkv_layers_on_both(p2, p2_cpu, cut,
                                                         x, state)
    ends = {"forward": (m.forward(p2, {"tokens": tokens.to(dev)}),
                        m.forward(p2_cpu, {"tokens": tokens}))}
    s_gpu = m.init_decode_state(2, 16, device=dev)
    s_cpu = m.init_decode_state(2, 16, device="cpu")
    for t in range(4):
        got, s_gpu = m.decode_step(p2, tokens[:, t].to(dev), s_gpu)
        want, s_cpu = m.decode_step(p2_cpu, tokens[:, t], s_cpu)
        ends[f"decode_{t}"] = (got, want)
    out["card_vs_cpu"] = {
        "layer_by_layer": gate,
        "end_to_end": {k: max_diff(g, w) for k, (g, w) in ends.items()},
        "end_to_end_token_agreement": {
            k: float((g.argmax(-1).cpu() == w.argmax(-1)).float().mean())
            for k, (g, w) in ends.items()}}
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    print(f"rwkv ({card}): 2 layers at full width, card against host CPU "
          f"(forward of 2x16 and 4 decode steps): layer by layer from the "
          f"card's inputs (largest output and WKV state difference over "
          f"their largest, then logits): {gate}; end to end, largest "
          f"logit differences {out['card_vs_cpu']['end_to_end']}, top-1 "
          f"agreement {out['card_vs_cpu']['end_to_end_token_agreement']} "
          f"({out['card_vs_cpu_s']:.2f} s)", flush=True)
    del params, params_cpu, p2, p2_cpu, state, s_gpu
    free_card()
    part("c")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"rwkv phase ({card}): {out['phase_s']:.2f} s (parts: "
          + ", ".join(f"({k}) {v:.2f} s" for k, v in out["part_s"].items())
          + ")", flush=True)
    assert out["phase_s"] < RWKV_PHASE_LIMIT_S, \
        f"phase 13 took {out['phase_s']:.1f} s, over {RWKV_PHASE_LIMIT_S} s"
    print(json.dumps({"rwkv_serving": out}), flush=True)
    return out


def smt_walk_rows(smt) -> list:
    """The walk kernels' entries of the kernels line: launches from phase
    7 (a), the rest at the engine's batch, `SMT_WALK_MAIN_N` boxes."""
    r = smt["walks"][SMT_WALK_MAIN_N]
    src = "src/repro_torch/smt/csrc/smt_walk.cu"
    return [{"name": "smt_hc4", "route": "cuda", "source": src,
             "replaces": "none (no TPU kernel: the reference's SMT engine "
                         "is numpy, src/repro/smt/solver.py:1057 "
                         "_hc4_rows)",
             "launches": smt["walk_launches"]["smt_hc4"],
             "max_abs_err": 0.0, "ms": r["hc4_ms"],
             "plain_ms": r["hc4_plain_ms"], "bound_ms": r["hc4_bound_ms"],
             "bound_by": r["hc4_bound_by"], "library_ms": None,
             "walks": smt["walks"]},
            {"name": "smt_grad", "route": "cuda", "source": src,
             "replaces": "none (no TPU kernel: the reference's SMT engine "
                         "is numpy, src/repro/smt/solver.py:1320 "
                         "_gradients_rows)",
             "launches": smt["walk_launches"]["smt_grad"],
             "max_abs_err": 0.0, "ms": r["grad_ms"],
             "plain_ms": r["grad_plain_ms"], "bound_ms": r["grad_bound_ms"],
             "bound_by": r["grad_bound_by"], "library_ms": None}]


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

    # -- 9. sharded and f32 --------------------------------------------------
    sharded = sharded_and_f32(dev, card, params)

    # -- 10. LM serving ------------------------------------------------------
    lm_serving(dev, card)

    # -- 11. MoE serving -----------------------------------------------------
    moe_serving(dev, card)

    # -- 12. VLM and encoder-decoder serving -------------------------------
    vlm_encdec_serving(dev, card)

    # -- 13. RWKV6 serving ---------------------------------------------------
    rwkv_serving(dev, card)

    # -- 14. result lines --------------------------------------------------
    print(f"chip_smoke: phases 1-13 in {time.perf_counter() - t_script:.2f} s "
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
        "smt": smt, "workflows": workflows, "sharded": sharded}]
        + library_rows + smt_walk_rows(smt)}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
