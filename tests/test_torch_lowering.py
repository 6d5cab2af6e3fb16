"""The port's lowering layers against the JAX package's, field by field.

`repro_torch.lowering.ir.lower`, `schedule.build_schedule` and
`islands.partition_islands` are the port's own copies of the
reference's JAX-free layers; here they must produce the same typed
stages, the same band schedules and the same rate islands.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.lowering as rl
import repro_torch.lowering as pl_
from repro.lowering import backends as rb
from repro_torch.lowering import backends as pb
from repro_torch.pipelines.types import types_from_data
from test_torch_types import BENCHES, IDS, ref_types, to_data
from _torch_threads import one_torch_thread  # noqa: F401

SHAPES = [(48, 48), (47, 48), (64, 64)]


def _lower_both(ref_build, port_build, params, datapath="exact"):
    rpipe = ref_build()
    types = ref_types(rpipe)
    rlp = rl.lower(rpipe, types, params=params, datapath=datapath)
    plp = pl_.lower(port_build(), types_from_data(to_data(types)),
                    params=params, datapath=datapath)
    return rlp, plp


def _stage_fields(ls):
    t = None if ls.t is None else (ls.t.alpha, ls.t.beta, ls.t.signed)
    phase = None if ls.phase is None else (
        ls.phase.lattice, ls.phase.int_ok,
        sorted((r, (p.alpha, p.beta, p.signed))
               for r, p in ls.phase.types.items()))
    return dict(kind=ls.kind, t=t, halo=ls.halo,
                int_taps=[dataclasses.astuple(tp) for tp in ls.int_taps],
                sm=ls.sm, t_shift=ls.t_shift, dyadic=ls.dyadic,
                cscale=ls.cscale, carrier=ls.carrier,
                acc_bound=ls.acc_bound, acc_split=ls.acc_split,
                expr_dtype=ls.expr_dtype, phase=phase,
                store_float=ls.store_float, election=ls.election,
                stride=ls.stage.stride, upsample=ls.stage.upsample,
                inputs=ls.stage.inputs, expr=repr(ls.stage.expr))


@pytest.mark.parametrize("datapath", ["exact", "narrow"])
@pytest.mark.parametrize("name,ref_build,port_build,params", BENCHES,
                         ids=IDS)
def test_lower_matches_the_reference(name, ref_build, port_build, params,
                                     datapath):
    rlp, plp = _lower_both(ref_build, port_build, params, datapath)
    assert plp.order == rlp.order
    assert plp.params == rlp.params
    for n in rlp.order:
        assert _stage_fields(plp.stages[n]) == _stage_fields(rlp.stages[n]), n
        assert pb.store_dtype(plp.stages[n]) == torch.from_numpy(
            np.zeros(1, dtype=np.dtype(rb.store_dtype(rlp.stages[n])))).dtype


def _sched_fields(s):
    return (s.grid, s.tile_rows, s.order,
            {n: (ss.step, ss.lo, ss.hi, ss.H, ss.W)
             for n, ss in s.stages.items()})


@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s))
                                               for s in SHAPES])
@pytest.mark.parametrize("name,ref_build,port_build,params", BENCHES,
                         ids=IDS)
def test_schedules_and_islands_match_the_reference(name, ref_build,
                                                   port_build, params,
                                                   shape):
    rlp, plp = _lower_both(ref_build, port_build, params)
    try:
        want = _sched_fields(rl.build_schedule(rlp, shape))
    except rl.LoweringError:
        with pytest.raises(pl_.LoweringError):
            pl_.build_schedule(plp, shape)
    else:
        assert _sched_fields(pl_.build_schedule(plp, shape)) == want
    rplan = rl.partition_islands(rlp, shape)
    pplan = pl_.partition_islands(plp, shape)
    assert (pplan.order, pplan.inputs, pplan.outputs) == \
        (rplan.order, rplan.inputs, rplan.outputs)
    assert len(pplan.islands) == len(rplan.islands)
    for pi, ri in zip(pplan.islands, rplan.islands):
        assert (pi.idx, pi.stages, pi.inputs, pi.outputs, pi.rate,
                pi.single_tile) == (ri.idx, ri.stages, ri.inputs,
                                    ri.outputs, ri.rate, ri.single_tile)
        assert _sched_fields(pi.schedule) == _sched_fields(ri.schedule)


def test_dus_at_47_rows_partitions_into_three_islands():
    rlp, plp = _lower_both(*BENCHES[2][1:])
    plan = pl_.partition_islands(plp, (47, 48))
    assert len(plan.islands) == 3
    assert [i.single_tile for i in plan.islands] == [False, True, False]
