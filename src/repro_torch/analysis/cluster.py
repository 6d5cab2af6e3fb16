"""Homogeneity clustering (paper §IV) as a real `AnalysisPass`.

The paper observes that image-processing DAGs are full of *homogeneous*
stages — same sampling rate, same signal statistics, same operator shape —
and that synthesizing one shared datapath per homogeneity class costs
almost nothing in precision while collapsing both the generated hardware
and the `(alpha, beta)` search space of the design search (one decision
per cluster instead of one per stage).

`ClusterPass` wraps any sub-pass: stages are grouped by

  * **rate** — the stage's output-grid rate relative to the pipeline root
    (exact `Fraction`s accumulated through stride/upsample, the same
    lattice walk the reference's `repro.smt.encoder.sampling_lattice`
    performs);
  * **signal statistics** — the sub-column's (signed, alpha) of the stage;
  * **datapath shape** — the operator census of the stage expression
    (`core.graph.expr_ops`) plus input arity, i.e. what the stage would
    synthesize to;
  * input-ness (input stages never merge with compute stages).

Each cluster's range is the join of its members' ranges and its alpha the
members' max — members share (signed, alpha) by construction, so the join
keeps the same alpha and every member range nests inside its cluster
range: `plan.check_nesting([sub_column, cluster_column])` holds.

The port's own copy of `repro.analysis.cluster`.  Its default sub-pass
is ``"smt"``, as in the reference; SMT is not ported yet, so building
the default raises, and callers name another sub-pass
(``cluster("interval")``).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional, Tuple

from repro_torch.core.graph import Pipeline, expr_ops
from repro_torch.core.interval import Interval
from repro_torch.core.range_analysis import StageRange

from repro_torch.analysis.passes import (PassContext, PassResult,
                                         make_pass, register_pass)

Rate = Tuple[Fraction, Fraction]


def stage_rates(pipeline: Pipeline) -> Dict[str, Rate]:
    """Output-grid rate of every stage relative to the pipeline root.

    rate(input) = 1; rate(stage) = rate(in) * upsample / stride per axis —
    the forward lattice accumulation of the phase-split encoder.
    """
    rates: Dict[str, Rate] = {}
    for name in pipeline.topo_order():
        st = pipeline.stages[name]
        if st.is_input or not st.inputs:
            rates[name] = (Fraction(1), Fraction(1))
            continue
        ry, rx = rates[st.inputs[0]]
        uy, ux = st.upsample
        sy, sx = st.stride
        rates[name] = (ry * uy / sy, rx * ux / sx)
    return rates


def _shape_sig(pipeline: Pipeline, name: str) -> Tuple:
    """Datapath-shape signature: operator census + arity + halo extent."""
    st = pipeline.stages[name]
    if st.is_input or st.expr is None:
        return ("input",)
    return (tuple(sorted(expr_ops(st.expr).items())), len(st.inputs),
            st.halo_yx())


def homogeneity_clusters(pipeline: Pipeline,
                         stage_ranges: Dict[str, StageRange],
                         ) -> List[List[str]]:
    """Partition stages into §IV homogeneity classes (topo-stable order).

    Two stages cluster iff they agree on rate, (signed, alpha) of the
    given range column, and datapath shape.  Singleton clusters are kept —
    every stage belongs to exactly one class.
    """
    rates = stage_rates(pipeline)
    groups: Dict[Tuple, List[str]] = {}
    for name in pipeline.topo_order():
        sr = stage_ranges[name]
        key = (pipeline.stages[name].is_input, rates[name],
               sr.signed, sr.alpha, _shape_sig(pipeline, name))
        groups.setdefault(key, []).append(name)
    # stable order: by first member's topo position
    order = {n: i for i, n in enumerate(pipeline.topo_order())}
    return sorted(groups.values(), key=lambda ms: order[ms[0]])


class ClusterPass:
    """Sub-pass ranges, re-joined per homogeneity cluster (see module doc).

    The emitted column assigns every member its cluster's joined range, so
    a consumer that types from this column automatically shares one
    (alpha, signed) decision per cluster; cluster membership lands in the
    column notes (and thus plan provenance / serialized JSON).
    """

    name = "cluster"

    def __init__(self, sub="smt", column: Optional[str] = None):
        self.sub = make_pass(sub)
        self.column = column or f"cluster({self.sub.column})"

    def key(self) -> str:
        return f"cluster({self.sub.key()})"

    def run(self, ctx: PassContext) -> PassResult:
        res = ctx.run(self.sub)
        srs = res.stage_ranges()
        clusters = homogeneity_clusters(ctx.pipeline, srs)
        ranges: Dict[str, Interval] = {}
        alphas: Dict[str, int] = {}
        for members in clusters:
            joined = srs[members[0]].range
            for m in members[1:]:
                joined = joined.join(srs[m].range)
            alpha = max(srs[m].alpha for m in members)
            for m in members:
                ranges[m] = joined
                alphas[m] = alpha
        n_multi = sum(1 for c in clusters if len(c) > 1)
        notes = [f"{len(clusters)} homogeneity cluster(s) over "
                 f"{len(ranges)} stage(s) ({n_multi} shared): "
                 + "; ".join("{" + ",".join(c) + "}" for c in clusters)]
        return PassResult(ranges=ranges, alphas=alphas,
                          notes=list(res.notes) + notes)


def cluster(sub="smt", column: Optional[str] = None) -> ClusterPass:
    return ClusterPass(sub, column=column)


register_pass("cluster", lambda **kw: ClusterPass(**kw))
