"""The port's pipeline server on the CPU: batching, padding, drain.

Results through `repro_torch.serve.PipelineServer` (plain version, CPU)
must equal the reference's numpy oracle frame by frame.
"""
import numpy as np
import pytest
import torch

from repro.dsl.exec import run_fixed as ref_run_fixed
from repro_torch.pipelines.types import types_from_data
from repro_torch.serve import PipelineServer, serve_offline
from test_torch_types import BENCHES, frames, ref_types, to_data
from _torch_threads import one_torch_thread  # noqa: F401

NAME, REF_BUILD, PORT_BUILD, PARAMS = BENCHES[0]          # usm


def _server(types, **kw):
    return PipelineServer(PORT_BUILD(), types_from_data(to_data(types)),
                          PARAMS, backend="torch", device="cpu", **kw)


def test_server_results_equal_the_oracle():
    types = ref_types(REF_BUILD())
    imgs = [frames((32, 40), 100 + i) for i in range(7)]
    with _server(types, batch_size=4) as srv:
        assert srv.warmup([(32, 40)]) == [(4, 32, 40)]
        assert srv.warmup([(32, 40)]) == []             # already warm
        outs = serve_offline(srv, imgs)
    # how many batches the 2 ms window forms depends on timing; every
    # frame is served and every batch is padded to 4
    assert srv.stats["frames"] == 7 and srv.stats["batches"] >= 2
    assert srv.stats["padded"] == 4 * srv.stats["batches"] - 7
    for img, out in zip(imgs, outs):
        want = ref_run_fixed(REF_BUILD(), img, types, PARAMS)
        assert out["masked"].device.type == "cpu"
        np.testing.assert_array_equal(out["masked"].numpy(),
                                      np.asarray(want["masked"]))
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(imgs[0])


def test_server_pads_a_lone_request_and_drains_on_close():
    types = ref_types(REF_BUILD())
    srv = _server(types, batch_size=4, batch_timeout_s=0.05)
    futs = [srv.submit(frames((24, 24), 5))]
    futs[0].result(timeout=60)                # lone request: padded 1 -> 4
    futs += [srv.submit(frames((24, 24), 6 + i)) for i in range(2)]
    srv.close()                               # drains the queued two
    srv.close()                               # idempotent
    assert all(f.done() for f in futs)
    assert srv.stats["frames"] == 3
    assert srv.stats["padded"] == 4 * srv.stats["batches"] - 3


def test_server_takes_uint8_frames_zero_copy():
    types = ref_types(REF_BUILD(), beta=0)
    f64 = [frames((32, 32), 200 + i) for i in range(5)]
    u8 = [f.astype(np.uint8) for f in f64]
    with _server(types, batch_size=4) as srv:
        frame = torch.from_numpy(u8[0])
        assert srv._quantize(frame, 0) is frame
        outs_u8 = serve_offline(srv, u8)
    with _server(types, batch_size=4) as srv:
        outs_f64 = serve_offline(srv, f64)
    for f, a, b in zip(f64, outs_u8, outs_f64):
        want = ref_run_fixed(REF_BUILD(), f, types, PARAMS)
        np.testing.assert_array_equal(a["masked"].numpy(),
                                      np.asarray(want["masked"]))
        assert torch.equal(a["masked"], b["masked"])
