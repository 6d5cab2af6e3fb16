"""The port's encoder-decoder (whisper: `repro_torch.models.encdec` and
`attention.cross_attend`) against the JAX package on the CPU.

Weights come across from the reference (`params_from_numpy`); inputs
from `numpy.random.default_rng` seeds (`make_batch` draws the frames).
The reference is held compiled (`jax.jit`): XLA computes the bf16
residual adds in f32 and a norm reads the unrounded sum, which the port
copies (`encdec._residual`).  Logits are held at MODEL_ATOL (2^-7) with
the top-1 rule, bf16 activations within one bf16 unit of the value or
of the tensor's largest value (`assert_bf16_close`), unless a case
states its own tolerance.  As in the reference, the batcher serves
whisper against zeroed cross K/V (ROADMAP, "Reference defects the port
copies").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.batches import make_batch as ref_make_batch
from repro.launch import serve as ref_serve
from repro.models import attention as RA
from repro.models import encdec as RE
from repro.models.registry import get_model as ref_get_model
from repro.quant import range_lm as ref_range_lm
from repro.serve.prefill import prefill as ref_prefill
from repro_torch import configs
from repro_torch.data.batches import make_batch
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import encdec as E
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.quant import range_lm
from repro_torch.serve.prefill import prefill
from test_torch_lm import (BF16_ULP, MODEL_ATOL, _ref_specs,
                           _specs, assert_logits_close, carry, f32,
                           ref_params)
from test_torch_lm_serve import _generate
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-medium"
CPU = torch.device("cpu")


def assert_bf16_close(got, want):
    """Within one bf16 unit of the reference's value, or of the tensor's
    largest value: a one-unit difference in an attention sum (the
    reduction order is XLA's own) moves a cancelling output projection
    by more than its own unit (a chunked `cross_attend` case: 9.2e-5 on
    0.0043), and spreads through the encoder's bidirectional layers
    (whisper-smoke's encoder output: 0.0156 on values up to about 4).
    The largest difference."""
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=BF16_ULP,
                               atol=BF16_ULP * float(np.abs(want).max()))
    return float(np.abs(got - want).max())


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_encdec_param_specs_equal_the_reference(smoke):
    """Shapes, logical axes and init kinds leaf for leaf (nothing
    allocated)."""
    get = configs.get_smoke_config if smoke else configs.get_config
    rget = ref_configs.get_smoke_config if smoke else ref_configs.get_config
    cfg = get(ARCH)
    m, rm = get_model(cfg), ref_get_model(rget(ARCH))
    want = _ref_specs(rm.param_specs())
    assert _specs(m.param_specs()) == want
    assert _specs(E.param_specs(cfg)) == want
    axes = dict(C.tree_items(m.param_axes(),
                             is_leaf=lambda x: isinstance(x, tuple)))
    assert {"/".join(p): a for p, a in axes.items()} == \
        {k: v[1] for k, v in want.items()}
    assert {k.split("/")[0] for k in want} == {
        "embed", "enc_blocks", "enc_norm", "dec_blocks", "final_norm",
        "unembed"}


def test_params_from_numpy_carries_the_encdec_tree():
    """The reference's `init_params(PRNGKey(0))` tree (enc_blocks,
    dec_blocks with cross, enc_norm): every leaf of its path, dtype,
    shape and values, tolerance 0."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_get_model(rcfg).init_params(jax.random.PRNGKey(0))
    got = dict(C.tree_items(params_from_numpy(
        jax.tree.map(np.asarray, rp), CPU)))
    leaves = jax.tree_util.tree_flatten_with_path(rp)[0]
    want = {tuple(k.key for k in p): np.asarray(v) for p, v in leaves}
    assert set(got) == set(want)
    assert ("dec_blocks", "cross", "wk") in got and ("enc_norm",) in got
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == \
            v.shape
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_init_params_draws_the_encdec_tree_on_the_generators_device():
    cfg = configs.get_smoke_config(ARCH)
    m = get_model(cfg)
    a = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    b = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    for (pa, ta), (pb, tb) in zip(C.tree_items(a), C.tree_items(b)):
        assert pa == pb and torch.equal(ta, tb) and ta.device == CPU
    assert torch.equal(a["enc_norm"], torch.ones(cfg.d_model))
    assert _specs(m.param_specs()).keys() == {
        "/".join(p) for p, _ in C.tree_items(a)}


def test_make_batch_draws_the_reference_frames():
    cfg = configs.get_smoke_config(ARCH)
    got = make_batch(cfg, 2, 16, seed=5, device="cpu")
    want = ref_make_batch(ref_configs.get_smoke_config(ARCH), 2, 16, seed=5)
    assert set(got) == set(want) == {"tokens", "labels", "frames"}
    assert got["frames"].dtype == torch.float32
    assert tuple(got["frames"].shape) == (2, cfg.encoder_seq, cfg.d_model)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("S", [8, 2048], ids=["S8", "S2048-chunked"])
def test_cross_attend_equals_the_reference(S):
    """whisper-smoke's first decoder layer over 16 encoder positions; S
    = 2048 runs the query-chunked branch (S > QUERY_CHUNK, a multiple of
    it) in both packages.  Tolerance: `assert_bf16_close`."""
    assert S <= A.QUERY_CHUNK or S % A.QUERY_CHUNK == 0
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg, seed=1)
    lp = jax.tree.map(lambda a: a[0], rp["dec_blocks"]["cross"])
    rng = np.random.default_rng(S)
    x = jnp.asarray(rng.normal(size=(1, S, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    kv = jnp.asarray(rng.normal(size=(2, 1, 4, 16, 16)).astype(np.float32)
                     ).astype(jnp.bfloat16)
    want = jax.jit(lambda x, p, k, v: RA.cross_attend(x, p, rcfg, k, v))(
        x, lp, kv[0], kv[1])
    tkv = carry(kv)
    got = A.cross_attend(carry(x), carry(lp), configs.get_smoke_config(ARCH),
                         tkv[0], tkv[1])
    assert got.shape == (1, S, 64) and got.dtype == torch.bfloat16
    assert_bf16_close(got, want)


def _ref_whisper(rcfg):
    """One compiled function of the reference's encode, cross_kv,
    decode_train, forward, loss, and 3 decode steps from an empty
    self-attention cache over the encoder's cross K/V (max_len 16)."""
    rm = ref_get_model(rcfg)

    def run(rp, batch):
        enc = RE.encode(rp, batch["frames"], rcfg)
        ck, cv = RE.cross_kv(rp, enc, rcfg)
        out = {"encode": enc, "cross_kv": (ck, cv),
               "decode_train": RE.decode_train(rp, batch["tokens"], enc,
                                               rcfg),
               "forward": rm.forward(rp, batch),
               "loss": rm.loss_fn(rp, batch)}
        state = rm.init_decode_state(2, 16)
        out["init"] = state
        state = dict(state, cross_k=ck.astype(jnp.bfloat16),
                     cross_v=cv.astype(jnp.bfloat16))
        steps = []
        for t in range(3):
            logits, state = rm.decode_step(rp, batch["tokens"][:, t], state)
            steps.append((logits, state))
        out["decode"] = steps
        return out
    return jax.jit(run)


@pytest.fixture(scope="module")
def whisper_model():
    """whisper-smoke in both packages and the reference's compiled
    outputs on a 2x16 batch of tokens over 16 frames, computed once."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg)
    batch = ref_make_batch(rcfg, 2, 16, seed=4)
    out = _ref_whisper(rcfg)(rp, batch)
    out.update(cfg=configs.get_smoke_config(ARCH), rcfg=rcfg, rparams=rp,
               params=carry(rp), batch=batch, tbatch=carry(batch))
    return out


def test_encode_equals_the_reference(whisper_model):
    d = whisper_model
    got = E.encode(d["params"], d["tbatch"]["frames"], d["cfg"])
    assert got.dtype == torch.bfloat16 and got.shape == (2, 16, 64)
    assert_bf16_close(got, d["encode"])


def test_cross_kv_equals_the_reference(whisper_model):
    """(L, B, KV, T, hd) bf16 K and V of the reference's encoder output."""
    d = whisper_model
    ck, cv = E.cross_kv(d["params"], carry(d["encode"]), d["cfg"])
    for got, want in zip((ck, cv), d["cross_kv"]):
        assert got.dtype == torch.bfloat16
        assert tuple(got.shape) == tuple(want.shape) == (2, 2, 4, 16, 16)
        assert_bf16_close(got, want)


def test_decode_train_equals_the_reference(whisper_model):
    d = whisper_model
    got = E.decode_train(d["params"], d["tbatch"]["tokens"],
                         carry(d["encode"]), d["cfg"])
    assert got.dtype == torch.float32
    assert got.shape == (2, 16, d["cfg"].vocab_padded)
    assert_logits_close(got, d["decode_train"], MODEL_ATOL, 0)


def test_forward_equals_the_reference(whisper_model):
    d = whisper_model
    got = get_model(d["cfg"]).forward(d["params"], d["tbatch"])
    assert_logits_close(got, d["forward"], MODEL_ATOL, 0)


def test_loss_fn_equals_the_reference(whisper_model):
    """The forward value, rtol 1e-4 as the dense decoders' test."""
    d = whisper_model
    loss, metrics = get_model(d["cfg"]).loss_fn(d["params"], d["tbatch"])
    want, wm = d["loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    for k in ("loss", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]),
                                   rtol=1e-4)


def test_init_decode_state_and_decode_step_equal_the_reference(
        whisper_model):
    """The empty state equal (zeroed self and cross K/V of
    `encoder_seq` positions); then three steps over the reference's cross
    K/V: logits within MODEL_ATOL with the top-1 rule, the self-attention
    cache within one bf16 unit, the cross K/V passed through unchanged,
    the length equal."""
    d = whisper_model
    m = get_model(d["cfg"])
    state = m.init_decode_state(2, 16, device="cpu")
    assert set(state) == set(d["init"]) == {"k", "v", "cross_k", "cross_v",
                                            "length"}
    for k, v in d["init"].items():
        assert tuple(state[k].shape) == tuple(np.shape(v))
        np.testing.assert_array_equal(f32(state[k]), f32(v))
    ck, cv = carry(d["cross_kv"])
    state = dict(state, cross_k=ck, cross_v=cv)
    toks = d["tbatch"]["tokens"]
    for t, (want, wstate) in enumerate(d["decode"]):
        logits, state = m.decode_step(d["params"], toks[:, t], state)
        assert_logits_close(logits, want, MODEL_ATOL, 0)
        assert int(state["length"]) == int(wstate["length"]) == t + 1
        for k in ("k", "v"):
            assert_bf16_close(state[k], wstate[k])
        for k in ("cross_k", "cross_v"):
            np.testing.assert_array_equal(f32(state[k]), f32(wstate[k]))


def test_decode_step_shares_the_cross_kv_and_leaves_its_state():
    """The new state's cross K/V are the input state's own tensors (no
    copy a step); the self-attention caches are new, and the input state
    is left as it was."""
    cfg = configs.get_smoke_config(ARCH)
    m = get_model(cfg)
    params = m.init_params(torch.Generator().manual_seed(1))
    state = m.init_decode_state(2, 8, device="cpu")
    state["cross_k"].normal_(generator=torch.Generator().manual_seed(2))
    copy = {k: v.clone() for k, v in state.items()}
    _, new = m.decode_step(params, torch.tensor([3, 4], dtype=torch.int32),
                           state)
    assert new["cross_k"] is state["cross_k"]
    assert new["cross_v"] is state["cross_v"]
    assert new["k"] is not state["k"] and new["v"] is not state["v"]
    assert all(torch.equal(copy[k], v) for k, v in state.items())
    assert int(new["length"]) == 1 and bool(new["k"].any())


def test_decode_matches_decode_train_at_the_reference_criterion():
    """`tests/test_encdec_vlm.py::test_whisper_decode_matches_decode_train`
    on the port: its parameters (`init_params(PRNGKey(5))`, carried) and
    batch; 8 decode steps over the encoder's cross K/V against
    `decode_train` at atol 0.2 / rtol 0.05, the top-1 token equal on at
    least 85% of positions."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    m = get_model(cfg)
    params = carry(ref_get_model(rcfg).init_params(jax.random.PRNGKey(5)))
    batch = carry(ref_make_batch(rcfg, 1, 8, seed=9))
    enc = E.encode(params, batch["frames"], cfg)
    full = E.decode_train(params, batch["tokens"], enc, cfg).numpy()
    state = m.init_decode_state(1, 16, device="cpu")
    ck, cv = E.cross_kv(params, enc, cfg)
    state = dict(state, cross_k=ck.to(torch.bfloat16),
                 cross_v=cv.to(torch.bfloat16))
    outs = []
    for t in range(8):
        logits, state = m.decode_step(params, batch["tokens"][:, t], state)
        outs.append(logits.numpy())
    dec = np.stack(outs, axis=1)
    assert (full.argmax(-1) == dec.argmax(-1)).mean() >= 0.85
    np.testing.assert_allclose(dec, full, atol=0.2, rtol=0.05)


def test_batcher_tokens_equal_the_reference():
    """whisper-smoke, `init_params(PRNGKey(0))` carried across, 3
    requests of 4-token prompts from `default_rng(0)` on 2 slots, max_new
    8, max_len 64, the cross K/V zeroed as the reference's batcher leaves
    them: every generated token and the step count equal (tolerance 0)."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rm = ref_get_model(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, rcfg.vocab_size, size=4))
               for _ in range(3)]
    ref = _generate(ref_serve.ContinuousBatcher, ref_serve.Request, rm, rp,
                    prompts, 2, 64)
    port = _generate(serve.ContinuousBatcher, serve.Request,
                     get_model(configs.get_smoke_config(ARCH)), carry(rp),
                     prompts, 2, 64)
    assert port == ref
    assert all(len(g) == 8 for g in port[0])


def test_main_serves_whisper_on_the_cpu_when_asked(capsys):
    """`python -m repro_torch.launch.serve --arch whisper-medium --smoke
    --device cpu` takes the reference CLI's decode steps."""
    want = ref_serve.main(["--arch", ARCH, "--smoke"])
    got = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert got == want == 22
    assert "served 4 requests (32 tokens) in 22 decode steps" in \
        capsys.readouterr().out


def _raised(fn):
    try:
        fn()
    except Exception as e:          # noqa: BLE001 - the type is the point
        return type(e), str(e)
    return None


def test_prefill_on_whisper_raises_what_the_reference_raises():
    """`prefill` sends the encoder-decoder to `prefill_dense`, whose
    first assertion fails in both packages."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg)
    want = _raised(lambda: ref_prefill(rp, jnp.zeros((1, 4), jnp.int32),
                                       rcfg, 8))
    got = _raised(lambda: prefill(carry(rp), torch.zeros(
        (1, 4), dtype=torch.int32), configs.get_smoke_config(ARCH), 8))
    assert want is not None and want[0] is AssertionError
    assert got == want


def test_static_ranges_on_whisper_raise_what_the_reference_raises():
    """`quant.range_lm` on the encoder-decoder's parameters: the same
    exception and message in both packages (the tree has no `blocks`)."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg)
    want = _raised(lambda: ref_range_lm.static_ranges(rp, rcfg))
    got = _raised(lambda: range_lm.static_ranges(
        carry(rp), configs.get_smoke_config(ARCH)))
    assert want is not None and got == want
