"""The port's AutoQuant (`repro_torch.quant`) against the JAX package on
the CPU.  Quantization is held at tolerance 0; AutoQuant's search on the
reference test's fixture (`tests/test_quant.py`: qwen3-smoke,
`init_params(PRNGKey(0))`, two 2x16 probe batches of seeds 0 and 1) must
choose the same bits in the same number of profile passes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.interval import Interval as RefInterval
from repro.data.batches import make_batch as ref_make_batch
from repro.models.registry import get_model as ref_get_model
from repro.quant import autoquant as ref_aq
from repro.quant import calibrate as ref_cal
from repro.quant import qtypes as ref_qt
from repro.quant import range_lm as ref_range
from repro_torch.configs import get_smoke_config
from repro_torch.core.interval import Interval
from repro_torch.data.batches import make_batch
from repro_torch.models.common import tree_items
from repro_torch.models.registry import get_model
from repro_torch.quant import autoquant as aq
from repro_torch.quant import calibrate as cal
from repro_torch.quant import qtypes as qt
from repro_torch.quant import range_lm
from test_torch_lm import carry, ref_params
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def qwen():
    """The reference test's fixture, in both packages."""
    cfg = ref_smoke_config("qwen3-4b")
    m = ref_get_model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    batches = [ref_make_batch(cfg, 2, 16, seed=s) for s in range(2)]
    tcfg = get_smoke_config("qwen3-4b")
    return {"cfg": cfg, "m": m, "params": params, "batches": batches,
            "tm": get_model(tcfg), "tparams": carry(params),
            "tbatches": [make_batch(tcfg, 2, 16, seed=s, device="cpu")
                         for s in range(2)]}


@pytest.mark.parametrize("bits", [8, 4, 2, 12])
def test_quantize_symmetric_equals_the_reference(bits):
    """Codes, their dtype and the scale at tolerance 0, per channel and
    per tensor, an all-zero row included."""
    x = np.random.default_rng(bits).normal(size=(48, 40)).astype(np.float32)
    x[3] = 0
    for axis in (-1, 0, None):
        q, s = qt.quantize_symmetric(torch.from_numpy(x), bits=bits,
                                     axis=axis)
        rq, rs = ref_qt.quantize_symmetric(jnp.asarray(x), bits=bits,
                                           axis=axis)
        assert str(q.dtype).split(".")[-1] == str(rq.dtype)
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        np.testing.assert_array_equal(
            qt.dequantize_symmetric(q, s).numpy(),
            np.asarray(ref_qt.dequantize_symmetric(rq, rs)))


def test_fake_quant_ste_is_fake_quant_forward_and_identity_backward():
    x = torch.linspace(-1, 1, 32, requires_grad=True)
    y = qt.fake_quant_ste(x, bits=4)
    want = ref_qt.fake_quant_ste(jnp.linspace(-1, 1, 32), bits=4)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones(32))


@pytest.mark.parametrize("bits", [8, 4, 2, 12])
def test_fake_quant_params_equals_the_reference(qwen, bits):
    """Every leaf at tolerance 0, and the same leaves changed: the weights
    of the chosen classes (mlp and unembed here), never a norm."""
    chosen = {"mlp": bits, "unembed": bits}
    got = dict(tree_items(aq.fake_quant_params(qwen["tparams"], chosen)))
    want = {tuple(k.key for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(
                ref_aq.fake_quant_params(qwen["params"], chosen))[0]}
    assert set(got) == set(want)
    src = dict(tree_items(qwen["tparams"]))
    changed = {p for p in got if not torch.equal(got[p], src[p])}
    assert changed == {("blocks", "mlp", "w_down"), ("blocks", "mlp", "w_gate"),
                       ("blocks", "mlp", "w_up"), ("unembed",)}
    for p, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[p]))


def test_quantize_params_store_equals_the_reference(qwen):
    got = aq.quantize_params_store(qwen["tparams"], {"attn": 4, "embed": 8})
    want = ref_aq.quantize_params_store(qwen["params"],
                                        {"attn": 4, "embed": 8})
    assert list(got) == list(want)
    leaves = {cal._path_str(p): v for p, v in tree_items(qwen["tparams"])}
    for k, (kind, val) in got.items():
        assert kind == want[k][0]
        if kind == "raw":
            assert val is leaves[k]
            continue
        for a, b in zip(val, want[k][1]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_classify_path_and_path_strings_equal_the_reference(qwen):
    want = [ref_cal._path_str(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(qwen["params"])[0]]
    got = [cal._path_str(p) for p, _ in tree_items(qwen["tparams"])]
    assert got == want and "blocks/attn/wq" in got
    paths = want + ["unembed", "embed", "blocks/tmix/w_k", "cross/wq",
                    "shared_attn/wq", "blocks/moe/w_up", "blocks/cmix/w_v",
                    "in_proj", "final_norm", "x/y", "unembedding/w"]
    assert [cal.classify_path(p) for p in paths] == \
        [ref_cal.classify_path(p) for p in paths]
    assert cal.WEIGHT_CLASSES == ref_cal.WEIGHT_CLASSES
    assert cal.REVERSE_TOPO_CLASSES == ref_cal.REVERSE_TOPO_CLASSES


def test_weight_stats_equal_the_reference(qwen):
    """absmax exactly; rms (a mean over the tensor, summed in another
    order) within f32 rounding, rtol 1e-6."""
    got = cal.weight_stats(qwen["tparams"])
    want = ref_cal.weight_stats(qwen["params"])
    assert set(got) == set(want) == {"embed", "attn", "mlp", "unembed"}
    for c in want:
        assert got[c]["absmax"] == want[c]["absmax"]
        assert got[c]["n"] == want[c]["n"]
        np.testing.assert_allclose(got[c]["rms"], want[c]["rms"], rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen3-4b", "minicpm-2b", "rwkv6-3b",
                                  "zamba2-2.7b"])
def test_static_ranges_equal_the_reference(arch):
    """Every class's interval within f32 rounding (column sums in another
    order; rtol 1e-6) and the alpha table equal.  rwkv and the hybrid run
    on the reference's own parameter trees carried across."""
    cfg = ref_smoke_config(arch)
    rp = ref_params(cfg, seed=2)
    tp = carry(rp)
    got = range_lm.static_ranges(tp, get_smoke_config(arch))
    want = ref_range.static_ranges(rp, cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose([got[k].lo, got[k].hi],
                                   [want[k].lo, want[k].hi], rtol=1e-6)
    assert range_lm.static_alpha_table(tp, get_smoke_config(arch)) == \
        ref_range.static_alpha_table(rp, cfg)


def test_activation_stats_and_calibrated_ranges(qwen):
    """Logit ranges of the probe batches within the model tolerance of
    `test_torch_lm` (0.02), enclosed by the static ranges."""
    got = cal.calibrated_ranges(qwen["tm"], qwen["tparams"],
                                qwen["tbatches"])
    want = ref_cal.calibrated_ranges(qwen["m"], qwen["params"],
                                     qwen["batches"])
    assert set(got) == set(want)
    np.testing.assert_allclose([got["logits"].lo, got["logits"].hi],
                               [want["logits"].lo, want["logits"].hi],
                               atol=0.02)
    static = range_lm.static_ranges(qwen["tparams"], get_smoke_config(
        "qwen3-4b"))
    assert static["logits"].encloses(got["logits"])


def test_tensor_precision_equals_the_reference():
    for rng, beta in (((-3.5, 2.0), 5), ((0.0, 200.0), 0), ((-1e-3, 1e-3), 9)):
        got = qt.TensorPrecision.from_range("t", Interval(*rng), beta)
        want = ref_qt.TensorPrecision.from_range("t", RefInterval(*rng), beta)
        assert (got.fp.alpha, got.fp.beta, got.fp.signed, got.container,
                got.bits, qt.bytes_per_element(got)) == \
            (want.fp.alpha, want.fp.beta, want.fp.signed, want.container,
             want.bits, ref_qt.bytes_per_element(want))
    f = qt.TensorPrecision.float_ref("t", Interval(-1.0, 1.0))
    assert f.bits == 16 and qt.bytes_per_element(f) == 2.0


def test_autoquant_equals_the_reference(qwen):
    """The reference test's call (target 0.95): bits, uniform bits,
    profile passes and bytes ratio equal; quality within one token of the
    64 probed."""
    got = aq.autoquant(qwen["tm"], qwen["tparams"], qwen["tbatches"],
                       target_agreement=0.95)
    want = ref_aq.autoquant(qwen["m"], qwen["params"], qwen["batches"],
                            target_agreement=0.95)
    assert got.bits == want.bits
    assert got.uniform_bits == want.uniform_bits
    assert got.profile_passes == want.profile_passes
    assert got.bytes_ratio == want.bytes_ratio
    assert abs(got.quality - want.quality) <= 1 / 64
    assert got.quality >= 0.95


def test_token_agreement_equals_the_reference():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(2, 16, 32)).astype(np.float32)
    b = a + 0.3 * rng.normal(size=a.shape).astype(np.float32)
    assert aq.token_agreement(torch.from_numpy(a), torch.from_numpy(b)) == \
        ref_aq.token_agreement(jnp.asarray(a), jnp.asarray(b))
