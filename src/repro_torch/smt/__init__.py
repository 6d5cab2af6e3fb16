"""`repro_torch.smt` — SMT-style whole-DAG range analysis (paper §V-B).

Emulates the paper's SMT-solver-based alpha analysis without external
dependencies: the stage DAG is flattened into one constraint system over
shared input-pixel/parameter variables (`encoder`), satisfiability queries
"can stage s exceed T?" are answered by HC4 interval contraction + affine
relaxation + branch-and-prune (`solver`), and per-stage bounds are
tightened by the paper's dichotomic threshold search (`optimize`).

Queries run on the *batched-box* engine by default: the CSP is compiled
once into a flat op table (`encoder.compile_csp`) and the whole
branch-and-prune frontier is contracted/split as (N, nvars) lo/hi tensors
on the device the caller names (``None`` means the card) —
`SMTConfig(engine="scalar")` (or `analyze(pipe, domain="smt-scalar")`)
selects the box-at-a-time reference oracle, which runs on the host.

Stages read through stride/upsample boundaries use *phase-split* encoding
(`SMTConfig(phase_split=True)`, the default): one exactly-aligned CSP per
output-phase residue of the sampling lattice, solved as a single
OR-composed multi-phase query (`solver.decide_multi`) whose union bound
replaces the alignment-blind sampling cuts.

Importing this package registers the `"smt"` analysis domain, so

    from repro_torch.core.range_analysis import analyze
    analyze(pipeline, domain="smt")          # whole-DAG dispatch

is the complete integration surface (§IV-C).  The registry lazy-loads this
package on first use of the name, so the import is rarely explicit.

The port's own copy of `repro.smt`, which it equals bit for bit on the
CPU; the reference's optional z3 delegation (`z3backend`) is not ported.
"""
from repro_torch.smt import domain as _domain   # registers "smt" + "smt-scalar"
from repro_torch.smt.optimize import (BudgetExhaustedWarning, SMTConfig,
                                      alpha_table_smt, analyze_smt)

__all__ = ["BudgetExhaustedWarning", "SMTConfig", "analyze_smt",
           "alpha_table_smt"]
