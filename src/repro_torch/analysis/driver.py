"""`run_plan` — execute a declared pass DAG once per pipeline.

`run_plan` turns a list of passes (names or instances, combinators
included) into one `BitwidthPlan`.  Every pass execution is memoized on

    (pipeline content hash, input-range key, pass content key)

so re-running a plan, sharing a sub-pass between combinators, or a
pass re-running through `analyze(pipe, "interval")` all hit the
cache instead of re-analyzing.  The memo is process-global (plans are also
serializable for cross-process caching — see `BitwidthPlan.to_json`);
`clear_memo()` empties it and resets its counters.

The port's own copy of `repro.analysis.driver`: for the same pipeline and
passes, `run_plan` writes the reference's `BitwidthPlan.to_json` text.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.core.graph import Pipeline, pipeline_content_hash
from repro_torch.core.interval import Interval

from repro_torch.analysis.plan import BitwidthPlan, Provenance
from repro_torch.analysis.passes import AnalysisPass, PassResult, make_pass

_MEMO: Dict[tuple, PassResult] = {}
# obs counter groups (locked `.add()`, explicit `.reset()`) that remain
# plain dicts for their readers.
MEMO_STATS = obs.CounterGroup("analysis.memo", hits=0, misses=0)
# disk-backed plan cache (`run_plan(cache_dir=...)`)
DISK_CACHE_STATS = obs.CounterGroup("analysis.disk_cache",
                                    hits=0, misses=0, writes=0, skips=0)


def clear_memo() -> None:
    _MEMO.clear()
    MEMO_STATS.reset()
    DISK_CACHE_STATS.reset()


def _input_ranges_key(input_ranges: Optional[Dict[str, Interval]]) -> str:
    if not input_ranges:
        return ""
    return ";".join(f"{n}:[{iv.lo!r},{iv.hi!r}]"
                    for n, iv in sorted(input_ranges.items()))


@dataclasses.dataclass
class _Context:
    pipeline: Pipeline
    input_ranges: Optional[Dict[str, Interval]]
    pipe_hash: str

    def run(self, p: AnalysisPass) -> PassResult:
        key = (self.pipe_hash, _input_ranges_key(self.input_ranges), p.key())
        with obs.span("analysis.pass", **{"pass": p.name},
                      column=p.column, key=p.key()) as sp:
            hit = _MEMO.get(key)
            if hit is not None:
                MEMO_STATS.add("hits")
                sp.set(memo="hit")
                return hit
            MEMO_STATS.add("misses")
            sp.set(memo="miss")
            res = p.run(self)
            sp.set(notes=len(res.notes))
            _MEMO[key] = res
            return res

    def with_input_ranges(self, ir: Dict[str, Interval]) -> "_Context":
        return dataclasses.replace(self, input_ranges=ir)


def _disk_cache_key(pipe_hash: str, resolved: Sequence[AnalysisPass],
                    input_ranges, betas,
                    default_column: Optional[str] = None) -> Optional[str]:
    """Stable cross-process cache key, or None when a pass key is only
    process-local (custom profile runners get a per-process `runner#N`
    identity — caching those on disk would collide across processes)."""
    keys = [p.key() for p in resolved]
    if any(":runner#" in k for k in keys):
        return None
    h = hashlib.sha256()
    h.update(pipe_hash.encode())
    h.update(_input_ranges_key(input_ranges).encode())
    for k in keys:
        h.update(b"|")
        h.update(k.encode())
    h.update(repr(sorted((betas or {}).items())).encode())
    h.update((default_column or "").encode())
    return h.hexdigest()[:20]


def run_plan(pipeline: Pipeline, passes: Sequence,
             input_ranges: Optional[Dict[str, Interval]] = None,
             betas: Optional[Dict[str, int]] = None,
             default_column: Optional[str] = None,
             cache_dir: Optional[str] = None) -> BitwidthPlan:
    """Execute the declared pass DAG and collect columns into one plan.

    `passes` entries are registry names (``"interval"``, ``"smt"``, ...) or
    `AnalysisPass` instances (combinators included).  Columns land in the
    plan under each pass's `column` name, with provenance carrying the
    pass's memoization key and notes.

    `cache_dir` opts into the disk-backed plan cache: plans serialize
    stably (`BitwidthPlan.to_json`), so CI and benchmark runs reuse
    cross-run analysis results keyed on `pipeline_content_hash` + every
    pass's content key (+ input ranges, betas, default column).  Passes
    with process-local identities (custom profile runners) skip the disk
    cache with a `RuntimeWarning`; the in-process memo still applies.
    """
    resolved: List[AnalysisPass] = [make_pass(p) for p in passes]
    pipe_hash = pipeline_content_hash(pipeline)
    with obs.span("analysis.run_plan", pipeline=pipeline.name,
                  hash=pipe_hash, n_passes=len(resolved)) as sp:
        cache_path = None
        if cache_dir is not None:
            key = _disk_cache_key(pipe_hash, resolved, input_ranges, betas,
                                  default_column)
            if key is None:
                DISK_CACHE_STATS.add("skips")
                sp.set(disk_cache="skip")
                obs.warn_once(
                    "plan disk cache skipped: a pass key is process-local "
                    "(custom profile runner); pass key_suffix= for a stable "
                    "identity")
            else:
                cache_path = os.path.join(
                    cache_dir, f"{pipeline.name}-{pipe_hash}-{key}.plan.json")
                if os.path.exists(cache_path):
                    try:
                        with open(cache_path) as f:
                            plan = BitwidthPlan.from_json(f.read())
                        if plan.content_hash == pipe_hash:
                            DISK_CACHE_STATS.add("hits")
                            sp.set(disk_cache="hit")
                            return plan
                    except (OSError, ValueError, KeyError):
                        pass      # corrupt entry: fall through and rewrite
                DISK_CACHE_STATS.add("misses")
                sp.set(disk_cache="miss")
        ctx = _Context(pipeline=pipeline, input_ranges=input_ranges,
                       pipe_hash=pipe_hash)
        plan = BitwidthPlan(pipeline=pipeline.name,
                            content_hash=ctx.pipe_hash,
                            betas=dict(betas or {}))
        for p in resolved:
            res = ctx.run(p)
            plan.add_column(p.column, res.stage_ranges(),
                            Provenance(pass_name=p.name, spec=p.key(),
                                       notes=list(res.notes)),
                            phases=res.phase_stage_ranges())
        if default_column:
            plan.default_column = default_column
        if cache_path is not None:
            os.makedirs(cache_dir, exist_ok=True)
            tmp = cache_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(plan.to_json())
            os.replace(tmp, cache_path)
            DISK_CACHE_STATS.add("writes")
        return plan


def one_pass_ranges(pipeline: Pipeline, domain, input_ranges=None):
    """Shim backend for `core.range_analysis.analyze`: a one-pass plan.

    String domains map onto registry passes (so results are memoized and
    plan-consistent); `Domain` instances fall through to the direct walk —
    they have no stable content key to memoize on.
    """
    from repro_torch.core.range_analysis import analyze_direct
    if not isinstance(domain, str):
        return analyze_direct(pipeline, domain, input_ranges=input_ranges)
    try:
        p = make_pass(domain)
    except KeyError:
        # unknown to the pass registry: let the domain registry resolve it
        # (custom user domains registered via absval.register_domain)
        return analyze_direct(pipeline, domain, input_ranges=input_ranges)
    plan = run_plan(pipeline, [p], input_ranges=input_ranges)
    return plan.stage_ranges(p.column)
