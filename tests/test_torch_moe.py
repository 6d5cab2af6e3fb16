"""The port's MoE feed-forward (`repro_torch.models.moe`) and the MoE
decoders (qwen2moe-smoke, mixtral-smoke) against the JAX package on the
CPU.

Weights come across from the reference (`params_from_numpy`); inputs
from `numpy.random.default_rng` seeds.  The reference is held compiled
(`jax.jit`): XLA feeds silu the gate projection's unrounded f32 sums and
multiplies the combine's bf16 outputs and weights in f32, and the port
copies both (`moe.moe_ffn`).  Each test states its tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.batches import make_batch as ref_make_batch
from repro.launch import serve as ref_serve
from repro.models import moe as RM
from repro.models.common import dense as ref_dense
from repro.models.registry import get_model as ref_get_model
from repro.quant import autoquant as ref_aq
from repro_torch import configs
from repro_torch.data.batches import make_batch
from repro_torch.launch import serve
from repro_torch.models import moe as M
from repro_torch.models.common import tree_items
from repro_torch.models.registry import get_model
from repro_torch.quant import autoquant as aq
from repro_torch.serve.prefill import prefill
from test_torch_lm import (BF16_ULP, MODEL_ATOL, _ref_outputs, _ref_specs,
                           _specs, assert_logits_close, carry, f32,
                           ref_params)
from test_torch_lm_serve import _generate
from _torch_threads import one_torch_thread  # noqa: F401

MOE = ["qwen2-moe-a2.7b", "mixtral-8x7b"]
CPU = torch.device("cpu")
# the largest moe_ffn difference allowed: one bf16 unit at 0.25, above
# the outputs' size (|out| < 0.3); seen: 1.2e-4 on 1 of 8,192 values
# (qwen2moe-smoke, seed 0, 128 tokens), every other case 0
FFN_MAX_DIFF = 2.0 ** -9


def _moe_params(rcfg, seed):
    """One layer's MoE parameters (not stacked) of the reference's
    shapes, normal with std 0.05, as jnp arrays."""
    rng = np.random.default_rng(seed)
    return {k: jnp.asarray((0.05 * rng.standard_normal(s.shape)
                            ).astype(np.float32))
            for k, s in RM.moe_param_specs(rcfg).items()}


def _x(shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


def _ref_ffn(rcfg):
    return jax.jit(lambda x, p: RM.moe_ffn(x, p, rcfg))


def _ref_routes(rcfg):
    """The reference's route (`moe.py:75-85`): top-k experts and their
    slots, jitted."""
    E, k = rcfg.n_experts, rcfg.top_k

    def run(x, router):
        xt = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(ref_dense(xt, router).astype(jnp.float32))
        _, top_e = jax.lax.top_k(probs, k)
        assign = jax.nn.one_hot(top_e, E, dtype=jnp.int32).reshape(-1, E)
        pos = jnp.sum((jnp.cumsum(assign, axis=0) - assign) * assign, -1)
        return top_e, pos
    return jax.jit(run)


def _port_routes(cfg, x, router):
    xt = x.reshape(-1, x.shape[-1])
    _, _, top_e = M.route(xt, router, cfg)
    return top_e, M._positions(top_e, cfg.n_experts)


def _ref_capacity(rcfg, tokens):
    """The capacity the reference's dispatch buffer (E, cap, D) takes,
    read off its traced program (nothing computed)."""
    x = jax.ShapeDtypeStruct((1, tokens, rcfg.d_model), jnp.bfloat16)
    p = {n: jax.ShapeDtypeStruct(s.shape, jnp.float32)
         for n, s in RM.moe_param_specs(rcfg).items()}
    jaxpr = jax.make_jaxpr(lambda x, p: RM.moe_ffn(x, p, rcfg))(x, p)
    caps = {v.aval.shape[1] for e in jaxpr.eqns for v in e.outvars
            if e.primitive.name == "broadcast_in_dim"
            and len(v.aval.shape) == 3
            and v.aval.shape[0] == rcfg.n_experts
            and v.aval.shape[2] == rcfg.d_model}
    cap, = caps
    return cap


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_param_specs_equal_the_reference(arch, smoke):
    """Shapes, logical axes and init kinds leaf for leaf, stacked and
    alone, and the whole model's tree (the `blocks/moe/*` leaves, shared
    experts included); nothing allocated."""
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = (ref_configs.get_smoke_config if smoke
               else ref_configs.get_config)
    cfg, rcfg = get(arch), ref_get(arch)
    for stacked in (None, cfg.n_layers):
        assert _specs(M.moe_param_specs(cfg, stacked)) == \
            _ref_specs(RM.moe_param_specs(rcfg, stacked))
    got = _specs(get_model(cfg).param_specs())
    assert got == _ref_specs(ref_get_model(rcfg).param_specs())
    moe_leaves = {k for k in got if k.startswith("blocks/moe/")}
    want = {"router", "w_gate", "w_up", "w_down"}
    if cfg.shared_expert_d_ff:
        want |= {"shared_gate", "shared_up", "shared_down",
                 "shared_gate_proj"}
    assert moe_leaves == {f"blocks/moe/{k}" for k in want}
    assert not any(k.startswith("blocks/mlp/") for k in got)


@pytest.mark.parametrize("arch", MOE)
def test_params_from_numpy_carries_the_moe_leaves(arch):
    """Every leaf of the reference's tree, `blocks/moe/*` included, at
    its shape and values (f32 and bf16)."""
    rcfg = ref_configs.get_smoke_config(arch)
    rp = ref_params(rcfg, seed=1)
    tp = carry(rp)
    want = {"/".join(k.key for k in p): v for p, v in
            jax.tree_util.tree_flatten_with_path(rp)[0]}
    got = {"/".join(p): v for p, v in tree_items(tp)}
    assert set(got) == set(want)
    assert "blocks/moe/w_down" in got
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].device == CPU
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
    bf = carry(jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                            rp["blocks"]["moe"]))
    assert bf["w_up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        f32(bf["w_up"]),
        np.asarray(rp["blocks"]["moe"]["w_up"].astype(jnp.bfloat16)
                   .astype(jnp.float32)))


# ---------------------------------------------------------------------------
# moe_ffn against the jitted reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 16), (4, 1), (1, 128)],
                         ids=["2x16", "4x1", "1x128"])
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_equals_the_jitted_reference(arch, seed, shape):
    """Routes (top-k experts and capacity slots) equal; the output within
    MODEL_ATOL, its largest difference at most FFN_MAX_DIFF."""
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    rp = _moe_params(rcfg, seed)
    tp = carry(rp)
    x = _x(shape + (rcfg.d_model,), 100 + seed)
    want_e, want_pos = _ref_routes(rcfg)(x, rp["router"])
    got_e, got_pos = _port_routes(cfg, carry(x), tp["router"])
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    want = _ref_ffn(rcfg)(x, rp)
    got = M.moe_ffn(carry(x), tp, cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_ATOL, rtol=0)
    assert np.abs(f32(got) - f32(want)).max() <= FFN_MAX_DIFF


@pytest.mark.parametrize("factor", [0.5, 0.25])
def test_moe_ffn_drops_the_tokens_the_reference_drops(factor):
    """qwen2moe-smoke over 64 tokens with a lower capacity factor: the
    reference's capacity (16 slots, then 8) drops choices, and the port
    drops the same ones (slots equal, the same choices at or past
    capacity); the output within MODEL_ATOL, the largest difference at
    most FFN_MAX_DIFF."""
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(
        "qwen2-moe-a2.7b"), capacity_factor=factor)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-moe-a2.7b"),
                              capacity_factor=factor)
    cap = M.capacity(cfg, 64)
    assert cap == _ref_capacity(rcfg, 64) == {0.5: 16, 0.25: 8}[factor]
    rp = _moe_params(rcfg, 7)
    tp = carry(rp)
    x = _x((2, 32, rcfg.d_model), 8)
    _, want_pos = _ref_routes(rcfg)(x, rp["router"])
    _, got_pos = _port_routes(cfg, carry(x), tp["router"])
    dropped = np.asarray(want_pos) >= cap
    assert dropped.sum() > 0
    np.testing.assert_array_equal(got_pos.numpy() >= cap, dropped)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    want = _ref_ffn(rcfg)(x, rp)
    got = M.moe_ffn(carry(x), tp, cfg)
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_ATOL, rtol=0)
    assert np.abs(f32(got) - f32(want)).max() <= FFN_MAX_DIFF


@pytest.mark.parametrize("arch", MOE)
def test_tied_router_probabilities_pick_the_lowest_experts(arch):
    """Zero router weights tie every expert: both packages pick experts
    0..k-1 for every token (`jax.lax.top_k`'s order), and the overflow
    drops the same choices; the output within MODEL_ATOL."""
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    rp = dict(_moe_params(rcfg, 3),
              router=jnp.zeros((rcfg.d_model, rcfg.n_experts), jnp.float32))
    tp = carry(rp)
    x = _x((2, 16, rcfg.d_model), 9)
    want_e, want_pos = _ref_routes(rcfg)(x, rp["router"])
    got_e, got_pos = _port_routes(cfg, carry(x), tp["router"])
    first = np.broadcast_to(np.arange(rcfg.top_k), (32, rcfg.top_k))
    np.testing.assert_array_equal(np.asarray(want_e), first)
    np.testing.assert_array_equal(got_e.numpy(), first)
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    want = _ref_ffn(rcfg)(x, rp)
    got = M.moe_ffn(carry(x), tp, cfg)
    np.testing.assert_allclose(f32(got), f32(want), atol=MODEL_ATOL, rtol=0)


@pytest.mark.parametrize("tokens,experts", [(1, 8), (48, 60)])
def test_capacity_equals_the_reference_rounding(tokens, experts):
    """`moe.py:70-71` over every k and a spread of capacity factors: the
    reference's buffer width, below 8, between 8 and 256 and above."""
    base = ref_configs.get_smoke_config("qwen2-moe-a2.7b")
    seen = set()
    for k in (1, 2, 4):
        for cf in (0.25, 1.0, 1.25, 2.0, 40.0, 3000.0):
            rcfg = dataclasses.replace(base, n_experts=experts, top_k=k,
                                       capacity_factor=cf)
            cfg = dataclasses.replace(
                configs.get_smoke_config("qwen2-moe-a2.7b"),
                n_experts=experts, top_k=k, capacity_factor=cf)
            want = _ref_capacity(rcfg, tokens)
            assert M.capacity(cfg, tokens) == want, (k, cf)
            seen.add(want)
    assert min(seen) == 8 and max(seen) > 256


def test_aux_load_balance_loss_equals_the_reference():
    """Random probabilities and routes: the loss within f32 rounding
    (means summed in another order; rtol 1e-6)."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(40, 6)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1)[:, :2].astype(np.int32)
    want = RM.aux_load_balance_loss(jnp.asarray(probs), jnp.asarray(top_e), 6)
    got = M.aux_load_balance_loss(torch.from_numpy(probs),
                                  torch.from_numpy(top_e).long(), 6)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    # a route of the port's own gives the same loss as the reference's
    rcfg = ref_configs.get_smoke_config("qwen2-moe-a2.7b")
    cfg = configs.get_smoke_config("qwen2-moe-a2.7b")
    rp = _moe_params(rcfg, 4)
    x = _x((40, rcfg.d_model), 6)
    tprobs, _, tops = M.route(carry(x), carry(rp)["router"], cfg)
    rprobs = jax.nn.softmax(ref_dense(x, rp["router"]).astype(jnp.float32))
    _, rtops = jax.lax.top_k(rprobs, rcfg.top_k)
    np.testing.assert_allclose(
        float(M.aux_load_balance_loss(tprobs, tops, cfg.n_experts)),
        float(RM.aux_load_balance_loss(rprobs, rtops, rcfg.n_experts)),
        rtol=1e-6)


# ---------------------------------------------------------------------------
# the MoE decoders: forward, loss, decode, prefill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE)
def moe_model(request):
    """An MoE smoke model in both packages and the reference's compiled
    outputs on a 2x16 batch (`test_torch_lm._ref_outputs`: forward, loss,
    3 decode steps with bf16 and int8 caches, an 8-token prefill)."""
    arch = request.param
    rcfg = ref_configs.get_smoke_config(arch)
    rp = ref_params(rcfg)
    batch = ref_make_batch(rcfg, 2, 16, seed=4)
    out = _ref_outputs(rcfg)(rp, batch)
    out.update(arch=arch, cfg=configs.get_smoke_config(arch), rcfg=rcfg,
               rparams=rp, params=carry(rp), batch=batch)
    return out


def test_forward_equals_the_reference(moe_model):
    d = moe_model
    got = get_model(d["cfg"]).forward(d["params"], carry(d["batch"]))
    assert got.shape == (2, 16, d["cfg"].vocab_padded)
    assert got.dtype == torch.float32
    assert_logits_close(got, d["forward"], MODEL_ATOL, 0)


def test_loss_fn_equals_the_reference(moe_model):
    """rtol 1e-4, as the dense decoders' test."""
    d = moe_model
    loss, metrics = get_model(d["cfg"]).loss_fn(d["params"], carry(d["batch"]))
    want, wm = d["loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    for k in ("loss", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]),
                                   rtol=1e-4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_equals_the_reference(moe_model, kv):
    """Three steps from an empty cache: logits within MODEL_ATOL with the
    top-1 rule, the bf16 cache within one bf16 unit (int8 codes within
    one step), the length equal."""
    d = moe_model
    m = get_model(dataclasses.replace(d["cfg"], kv_cache_dtype=kv))
    state = m.init_decode_state(2, 16, device="cpu")
    toks = carry(d["batch"])["tokens"]
    for t, (want, wstate) in enumerate(d[f"decode_{kv}"]):
        logits, state = m.decode_step(d["params"], toks[:, t], state)
        assert_logits_close(logits, want, MODEL_ATOL, 0)
        assert int(state["length"]) == int(wstate["length"]) == t + 1
        for k in ("k", "v"):
            g, w = f32(state[k]), f32(wstate[k])
            if kv == "int8":
                assert np.abs(g - w).max() <= 1
            else:
                np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-6)


def test_prefill_equals_the_reference(moe_model):
    """Fused prefill of 8 tokens (capacity over 8 x 2 tokens, as the
    reference's): next-token logits with the top-1 rule at MODEL_ATOL,
    the bf16 cache within one unit, the length 8."""
    d = moe_model
    want, wstate = d["prefill"]
    got, state = prefill(d["params"], carry(d["batch"])["tokens"][:, :8],
                         d["cfg"], 16)
    assert_logits_close(got, want, MODEL_ATOL, 0)
    assert int(state["length"]) == int(wstate["length"]) == 8
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(state[k]), f32(wstate[k]),
                                   rtol=BF16_ULP, atol=1e-6)


def test_mixtral_decode_past_its_window_equals_the_reference():
    """mixtral-smoke (sliding window 16): 24 decode steps from an empty
    cache of 32 against the reference's jitted `decode_step`, logits
    within MODEL_ATOL with the top-1 rule at every step."""
    rcfg = ref_configs.get_smoke_config("mixtral-8x7b")
    assert rcfg.sliding_window == 16
    rm = ref_get_model(rcfg)
    m = get_model(configs.get_smoke_config("mixtral-8x7b"))
    rp = ref_params(rcfg, seed=5)
    tp = carry(rp)
    toks = ref_make_batch(rcfg, 2, 24, seed=6)["tokens"]
    ref_step = jax.jit(rm.decode_step)
    rstate = rm.init_decode_state(2, 32)
    state = m.init_decode_state(2, 32, device="cpu")
    for t in range(24):
        want, rstate = ref_step(rp, toks[:, t], rstate)
        got, state = m.decode_step(tp, carry(toks[:, t]), state)
        assert_logits_close(got, want, MODEL_ATOL, 0)
    assert int(state["length"]) == 24


def test_mixtral_decode_matches_forward_at_the_reference_criterion():
    """`tests/test_models_smoke.py::test_decode_matches_forward` on the
    port: its parameters (`init_params(PRNGKey(3))`, carried) and tokens,
    8 steps of decode against the forward at atol 0.18 / rtol 0.05, the
    top-1 token equal on at least 85% of positions."""
    rcfg = ref_configs.get_smoke_config("mixtral-8x7b")
    m = get_model(configs.get_smoke_config("mixtral-8x7b"))
    params = carry(ref_get_model(rcfg).init_params(jax.random.PRNGKey(3)))
    tokens = carry(ref_make_batch(rcfg, 1, 8, seed=7))["tokens"]
    full = m.forward(params, {"tokens": tokens}).numpy()
    state = m.init_decode_state(1, 16, device="cpu")
    outs = []
    for t in range(tokens.shape[1]):
        logits, state = m.decode_step(params, tokens[:, t], state)
        outs.append(logits.numpy())
    dec = np.stack(outs, axis=1)
    np.testing.assert_allclose(dec, full, atol=0.18, rtol=0.05)
    assert (full.argmax(-1) == dec.argmax(-1)).mean() >= 0.85


# ---------------------------------------------------------------------------
# serving and AutoQuant
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_batcher_tokens_equal_the_reference(kv):
    """qwen2moe-smoke, `init_params(PRNGKey(0))` carried across, the
    example's setup (4 requests of 4 tokens from `default_rng(0)`, 2
    slots, max_new 8, max_len 64): every generated token and the step
    count equal (tolerance 0)."""
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(
        "qwen2-moe-a2.7b"), kv_cache_dtype=kv)
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-moe-a2.7b"),
                              kv_cache_dtype=kv)
    rm = ref_get_model(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, rcfg.vocab_size, size=4))
               for _ in range(4)]
    ref = _generate(ref_serve.ContinuousBatcher, ref_serve.Request, rm, rp,
                    prompts, 2, 64)
    port = _generate(serve.ContinuousBatcher, serve.Request, get_model(cfg),
                     carry(rp), prompts, 2, 64)
    assert port == ref
    assert port[1] == 22 and all(len(g) == 8 for g in port[0])


def test_main_serves_moe_on_the_cpu_when_asked(capsys):
    """`python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --smoke
    --device cpu` takes the reference CLI's decode steps."""
    want = ref_serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke"])
    got = serve.main(["--arch", "qwen2-moe-a2.7b", "--smoke", "--device",
                      "cpu"])
    assert got == want == 22
    assert "served 4 requests (32 tokens) in 22 decode steps" in \
        capsys.readouterr().out


def test_autoquant_on_mixtral_equals_the_reference():
    """The `_lm_quant_bench` row of mixtral (`benchmarks/run.py:72`):
    `init_params(PRNGKey(0))` carried, probe batches of seeds 0 and 1,
    target 0.95.  Bits, uniform bits, profile passes and bytes ratio
    equal; quality within one token of the 64 probed."""
    rcfg = ref_configs.get_smoke_config("mixtral-8x7b")
    cfg = configs.get_smoke_config("mixtral-8x7b")
    rm = ref_get_model(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    want = ref_aq.autoquant(rm, rp, [ref_make_batch(rcfg, 2, 16, seed=s)
                                     for s in range(2)],
                            target_agreement=0.95)
    got = aq.autoquant(get_model(cfg), carry(rp),
                       [make_batch(cfg, 2, 16, seed=s, device="cpu")
                        for s in range(2)], target_agreement=0.95)
    assert got.bits == want.bits
    assert got.uniform_bits == want.uniform_bits
    assert got.profile_passes == want.profile_passes
    assert got.bytes_ratio == want.bytes_ratio
    assert abs(got.quality - want.quality) <= 1 / 64
