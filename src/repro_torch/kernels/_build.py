"""Build the port's CUDA sources with `nvcc`, load them with ctypes and
call them.

Each source under a `csrc/` directory (`<kernel>/csrc/*.cu`, and the
SMT engine's `smt/csrc/smt_walk.cu`) has one or more plain C entry
points.  It is compiled once into a shared library under
`build/kernels/` at the root of the checkout, named by a hash of the
source, of every other file under its `csrc/` directory except the
other sources (the headers it may include), and of the flags, so an
edited source or header rebuilds and an unchanged one loads from the
cache.
`build` starts one `nvcc` per missing library, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

HERE = Path(__file__).resolve().parent
BUILD_DIR = HERE.parents[2] / "build" / "kernels"
SOURCES = {"fused_band": HERE / "stencil" / "csrc" / "fused_band.cu",
           "stencil": HERE / "stencil" / "csrc" / "stencil.cu",
           "qmatmul": HERE / "qmatmul" / "csrc" / "qmatmul.cu",
           "qdq": HERE / "qdq" / "csrc" / "qdq.cu",
           "smt_walk": HERE.parent / "smt" / "csrc" / "smt_walk.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_c = ctypes
_P, _I, _I64 = _c.c_void_p, _c.c_int, _c.c_int64
# each library's C entry points and their argument types
SIGNATURES = {
    # meta, layout, ins, n_in, outs, n_out, ws, ws_per_block, batch,
    # band0, nbands, blocks, threads, stream / smem bytes, threads, f32,
    # out[4]
    "fused_band": {"fused_band_launch": [
        _P, _c.POINTER(_I), _c.POINTER(_P), _I, _c.POINTER(_P), _I, _P,
        _I64, _I, _I, _I, _I, _I, _P],
        "fused_band_occupancy": [_I, _I, _I, _c.POINTER(_I)]},
    # x, out, H, W, taps (int32 n x 3), n_taps, hy, hx, shift, qmin,
    # qmax, stream
    "stencil": {"stencil_launch": [
        _P, _P, _I, _I, _P, _I, _I, _I, _I, _I, _I, _P]},
    # a, b, a_pad, bt, [sa, sb,] out, M, N, K, stream / b, bt, K, N,
    # stream / info[8]
    "qmatmul": {"qmatmul_i32_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
                "qmatmul_dequant_launch": [_P, _P, _P, _P, _P, _P, _P, _I,
                                           _I, _I, _P],
                "qmatmul_pack_b_launch": [_P, _P, _I, _I, _P],
                "qmatmul_config": [_c.POINTER(_I)]},
    # x, codes, scales, NB, BS, dtype (0 f32, 1 bf16, 2 f16), stream /
    # codes, scales, out, NB, BS, stream / bad (uint64), dtype, stream
    "qdq": {"block_quantize_launch": [_P, _P, _P, _I64, _I, _I, _P],
            "block_dequantize_launch": [_P, _P, _P, _I64, _I, _P],
            "block_quantize_check": [_P, _I, _P]},
    # lo, hi, alive_in, alive_out, back_lo, back_hi, scratch, def_var,
    # opcode, argv, argc, pow_n, cmp, N, nvars, ndefs, rounds, stream /
    # ndefs, rounds / lo, hi, glo, ghi, def_var, opcode, argv, argc,
    # pow_n, cmp, N, nvars, ndefs, root, stream
    "smt_walk": {"smt_hc4_launch": [_P] * 13 + [_I] * 4 + [_P],
                 "smt_hc4_scratch_ints": [_I, _I],
                 "smt_grad_launch": [_P] * 10 + [_I] * 4 + [_P]},
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels")


def library_path(name: str) -> Path:
    """The library of kernel `name`, named by a hash of the flags and of
    every file under its source's directory, names included, but the
    other sources there: editing one source rebuilds only its library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    src_dir = SOURCES[name].parent
    others = {p for n, p in SOURCES.items() if n != name}
    for f in sorted(p for p in src_dir.rglob("*")
                    if p.is_file() and p not in others):
        h.update(str(f.relative_to(src_dir)).encode() + b"\0")
        h.update(f.read_bytes() + b"\0")
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every library in `names` that is not built yet, with one
    `nvcc` per source running in parallel; returns the library paths.
    The compiler's `-Xptxas -v` report lands beside each library."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        log = open(paths[n].with_suffix(".log"), "w")
        procs.append((n, tmp, log, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for n, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append(f"{n}: nvcc exited {rc}, see "
                          f"{paths[n].with_suffix('.log')}")
        else:
            os.replace(tmp, paths[n])   # atomic: concurrent builders agree
    if failed:
        raise RuntimeError("kernel build failed:\n  " + "\n  ".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, built at first use."""
    with _LOCK:
        if name not in _LOADED:
            lib = ctypes.CDLL(str(build([name])[name]))
            for fn_name, argtypes in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LOADED[name] = lib
        return _LOADED[name]


def launch(name: str, fn_name: str, tensors: Sequence[torch.Tensor],
           *scalars) -> None:
    """Call entry point `fn_name` of library `name` with the data
    pointers of `tensors` (contiguous, all on one CUDA device; None
    passes a null pointer), then `scalars`, then the device's current
    stream.  Raises on any other operand and when the call returns an
    error."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{fn_name}: unsupported device {dev}")
    for t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{fn_name}: every operand must be a "
                             f"contiguous tensor on {dev}")
    fn = getattr(load(name), fn_name)
    with torch.cuda.device(dev):
        rc = fn(*[None if t is None else t.data_ptr() for t in tensors],
                *scalars, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: " + (
            f"CUDA error {rc}" if rc > 0 else f"error {rc} (see the "
            f"entry point's comment in {SOURCES[name].name})"))
