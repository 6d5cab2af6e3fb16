"""The port's dense LM (`repro_torch.{configs,models,serve.prefill}`)
against the JAX package on the CPU.

Weights come across from the reference (`params_from_numpy`); inputs
from `numpy.random.default_rng` seeds.  The reference runs its layer
stack compiled (a `lax.scan` body), and the port follows the compiled
arithmetic (`repro_torch.models.blocks._residual`); the primitives are
held to the reference's jitted functions for the same reason.  XLA's own
cos, sin and rsqrt and its reduction order are not copied, so past the
first layer a bf16 value can come out one unit in the last place away.
Each test states its tolerance; the ceiling is the reference's own
prefill test's (atol 0.15, rtol 0.05 on logits), with the top-1 token
equal wherever the reference's top-2 margin exceeds the tolerance.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.batches import make_batch as ref_make_batch
from repro.models import attention as RA
from repro.models import common as RC
from repro.models.registry import get_model as ref_get_model
from repro.serve.prefill import prefill as ref_prefill
from repro_torch import configs
from repro_torch.data.batches import make_batch
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.models.registry import get_model, params_from_numpy
from repro_torch.serve.prefill import prefill
from _torch_threads import one_torch_thread  # noqa: F401

DENSE = ["qwen3-4b", "deepseek-7b", "minicpm-2b", "phi3-medium-14b"]
CPU = torch.device("cpu")
BF16_ULP = 2.0 ** -7     # one bf16 unit in the last place, relative, at most
ATTN_ATOL = 3e-5         # attention outputs where a sum cancels to ~0


def ref_params(cfg, seed=0):
    """Parameters of the reference's shapes and init rule (fan-in capped
    normal, ones, zeros), drawn from `default_rng(seed)`, as jnp arrays."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        if s.init in ("zeros", "ones"):
            return jnp.full(s.shape, float(s.init == "ones"), jnp.float32)
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        std = min(0.02 if s.init == "normal" else 0.006,
                  1.0 / np.sqrt(max(fan_in, 1)))
        return jnp.asarray((std * rng.standard_normal(s.shape)
                            ).astype(np.float32))
    return jax.tree.map(leaf, ref_get_model(cfg).param_specs(),
                        is_leaf=lambda x: isinstance(x, RC.ParamSpec))


def carry(tree):
    """A reference pytree (params or decode state) as port tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def f32(a):
    """A reference array or a port tensor as a numpy f32 array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def assert_logits_close(got, want, atol, rtol):
    """`got` within (atol, rtol) of `want`, and the same top-1 token
    wherever the reference's top-2 margin exceeds the tolerance."""
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    top2 = np.sort(want, axis=-1)[..., -2:]
    margin = top2[..., 1] - top2[..., 0]
    clear = margin > 2 * (atol + rtol * np.abs(top2[..., 1]))
    assert (got.argmax(-1) == want.argmax(-1))[clear].all()
    return float(np.abs(got - want).max())


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ref_configs.ARCH_IDS)
def test_configs_equal_the_reference(arch):
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for port, ref in ((configs.get_config(arch), ref_configs.get_config(arch)),
                      (configs.get_smoke_config(arch),
                       ref_configs.get_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert (port.hd, port.vocab_padded, port.is_moe,
                port.is_attention_free, port.sub_quadratic,
                port.param_count()) == \
               (ref.hd, ref.vocab_padded, ref.is_moe, ref.is_attention_free,
                ref.sub_quadratic, ref.param_count())
    assert set(configs.all_configs()) == set(ref_configs.all_configs())
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-5")


def _specs(tree):
    return {"/".join(p): (s.shape, s.axes, s.init)
            for p, s in C.tree_items(tree, is_leaf=lambda x: hasattr(
                x, "axes"))}


def _ref_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RC.ParamSpec))[0]
    return {"/".join(k.key for k in p): (s.shape, s.axes, s.init)
            for p, s in leaves}


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", DENSE)
def test_param_specs_equal_the_reference(arch, smoke):
    """Shapes, logical axes and init kinds leaf for leaf (nothing
    allocated), and the shape tree and axes tree built from them."""
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = (ref_configs.get_smoke_config if smoke
               else ref_configs.get_config)
    m, rm = get_model(get(arch)), ref_get_model(ref_get(arch))
    assert _specs(m.param_specs()) == _ref_specs(rm.param_specs())
    axes = dict(C.tree_items(m.param_axes(), is_leaf=lambda x:
                             isinstance(x, tuple)))
    assert axes == {p: v[1] for p, v in
                    ((tuple(k.split("/")), v) for k, v in
                     _ref_specs(rm.param_specs()).items())}
    shapes = dict(C.tree_items(L.abstract_params(get(arch)),
                               is_leaf=lambda x: isinstance(x, tuple)))
    assert all(dt == torch.float32 for _, dt in shapes.values())
    assert {"/".join(p): s for p, (s, _) in shapes.items()} == \
        {k: v[0] for k, v in _ref_specs(rm.param_specs()).items()}


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen2-moe-a2.7b",
                                  "paligemma-3b", "whisper-medium",
                                  "rwkv6-3b", "zamba2-2.7b"])
def test_get_model_names_the_slice_that_ports_other_archs(arch):
    """An arch whose class is still in `NOT_PORTED` (the hybrid) raises
    naming its ROADMAP item (5d); the MoE, VLM, encoder-decoder and rwkv
    archs (ported) build, their parameter specs the reference's."""
    cfg = configs.get_smoke_config(arch)
    if cfg.arch_class in L.NOT_PORTED:
        assert arch == "zamba2-2.7b"
        item = re.escape(L.NOT_PORTED[cfg.arch_class])
        assert item.startswith("5d")
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP Queue 1 item {item}"):
            get_model(cfg)
        return
    assert cfg.arch_class == {"paligemma-3b": "vlm",
                              "whisper-medium": "encdec",
                              "rwkv6-3b": "rwkv"}.get(arch, "moe")
    assert _specs(get_model(cfg).param_specs()) == \
        _ref_specs(ref_get_model(ref_configs.get_smoke_config(
            arch)).param_specs())


def test_init_params_draws_from_the_generator_on_its_device():
    cfg = configs.get_smoke_config("qwen3-4b")
    m = get_model(cfg)
    a = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    b = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    for (pa, ta), (pb, tb) in zip(C.tree_items(a), C.tree_items(b)):
        assert pa == pb and torch.equal(ta, tb)
        assert ta.dtype == torch.float32 and ta.device == CPU
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    std = float(a["blocks"]["mlp"]["w_up"].std())
    assert abs(std - 0.02) < 0.002       # fan-in capped normal, 0.02


def test_make_batch_draws_the_reference_tokens():
    cfg = configs.get_smoke_config("minicpm-2b")
    got = make_batch(cfg, 2, 16, seed=5, device="cpu")
    want = ref_make_batch(cfg, 2, 16, seed=5)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ---------------------------------------------------------------------------
# primitives, held to the reference's jitted functions at tolerance 0
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rng_inputs():
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(2, 16, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    return {
        "x": x, "xt": params_from_numpy(np.asarray(x), CPU),
        "g": (1 + 0.1 * rng.normal(size=64)).astype(np.float32),
        "w": (0.02 * rng.normal(size=(64, 256))).astype(np.float32),
        "w2": (0.02 * rng.normal(size=(64, 256))).astype(np.float32),
        "w3": (0.02 * rng.normal(size=(256, 64))).astype(np.float32),
        "q": jnp.asarray(rng.normal(size=(2, 16, 4, 16)).astype(np.float32)
                         ).astype(jnp.bfloat16),
    }


def test_rms_norm_dense_swiglu_equal_the_reference(rng_inputs):
    d = rng_inputs
    t = {k: torch.from_numpy(d[k]) for k in ("g", "w", "w2", "w3")}
    cases = [
        (jax.jit(RC.rms_norm)(d["x"], d["g"]), C.rms_norm(d["xt"], t["g"])),
        (jax.jit(RC.dense)(d["x"], d["w"]), C.dense(d["xt"], t["w"])),
        (jax.jit(RC.swiglu)(d["x"], d["w"], d["w2"], d["w3"]),
         C.swiglu(d["xt"], t["w"], t["w2"], t["w3"])),
    ]
    for want, got in cases:
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(f32(got), f32(want))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_equals_the_reference(rng_inputs, theta):
    """The folded frequencies exactly; XLA's cos and sin are its own, so
    a rotated bf16 value may lie one unit in the last place away."""
    q = rng_inputs["q"]
    pos = jnp.arange(16)[None, :] * 97           # angles up to 1455 rad
    want = jax.jit(RA.apply_rope, static_argnums=2)(q, pos, theta)
    got = A.apply_rope(params_from_numpy(np.asarray(q), CPU),
                       torch.arange(16)[None, :] * 97, theta)
    np.testing.assert_array_equal(
        f32(A.rope_freqs(16, theta)),
        f32(jax.jit(RA.rope_freqs, static_argnums=(0, 1))(16, theta)))
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_ULP, atol=0)
    assert (f32(got) != f32(want)).mean() < 0.01


@pytest.fixture(scope="module")
def qwen_layer():
    """qwen3-smoke's first layer (qk_norm, GQA 4/2), reference and port."""
    cfg = ref_configs.get_smoke_config("qwen3-4b")
    rp = ref_params(cfg)
    lp = jax.tree.map(lambda a: a[0], rp["blocks"]["attn"])
    return cfg, lp, carry(lp)


@pytest.mark.parametrize("S", [8, 2048], ids=["S8", "S2048-chunked"])
def test_attend_train_equals_the_reference(qwen_layer, S):
    """S = 2048 runs the query-chunked branch (S > QUERY_CHUNK, a
    multiple of it) in both packages.  Tolerance: one bf16 unit, or
    ATTN_ATOL where the output projection's sum cancels (the largest
    difference seen: 9.5e-6 on outputs of about 0.05)."""
    cfg, lp, tp = qwen_layer
    x = np.random.default_rng(S).normal(size=(1, S, 64)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.jit(lambda x, p: RA.attend_train(x, p, cfg))(xj, lp)
    got = A.attend_train(params_from_numpy(np.asarray(xj), CPU), tp, cfg)
    assert got.shape == (1, S, 64) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_ULP,
                               atol=ATTN_ATOL)


def _ref_cache(cfg, rng, B, S_max, length, int8):
    """A reference KVCache with random history before `length`."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = rng.normal(size=(B, KV, S_max, hd)).astype(np.float32)
    v = rng.normal(size=(B, KV, S_max, hd)).astype(np.float32)
    k[:, :, length:] = 0
    v[:, :, length:] = 0
    if not int8:
        return RA.KVCache(k=jnp.asarray(k).astype(jnp.bfloat16),
                          v=jnp.asarray(v).astype(jnp.bfloat16),
                          length=jnp.asarray(length, jnp.int32))
    ks = np.abs(k).max(-1, keepdims=True) / 127 + 1e-3
    vs = np.abs(v).max(-1, keepdims=True) / 127 + 1e-3
    return RA.KVCache(
        k=jnp.asarray(np.rint(k / ks), jnp.int8),
        v=jnp.asarray(np.rint(v / vs), jnp.int8),
        length=jnp.asarray(length, jnp.int32),
        k_scale=jnp.asarray(ks, jnp.float32),
        v_scale=jnp.asarray(vs, jnp.float32))


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_attend_decode_equals_the_reference(qwen_layer, int8):
    """One token against a cache holding 5 positions: the output within
    one bf16 unit, the new cache entries (codes and scales for int8) equal,
    the rest of the cache untouched, the reference's cache left as it
    was."""
    cfg, lp, tp = qwen_layer
    rng = np.random.default_rng(7 + int8)
    cache = _ref_cache(cfg, rng, 2, 12, 5, int8)
    x = jnp.asarray(rng.normal(size=(2, 1, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    want, wc = jax.jit(lambda x, p, c: RA.attend_decode(x, p, cfg, c))(
        x, lp, cache)
    tcache = A.KVCache(*(None if a is None else carry(a) for a in cache))
    before = [None if a is None else a.clone() for a in tcache]
    got, gc = A.attend_decode(carry(x), tp, cfg, tcache)
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_ULP,
                               atol=ATTN_ATOL)
    for g, w, b in zip(gc, wc, before):
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(f32(g), f32(w))
    for a, b in zip(tcache, before):
        assert a is None or torch.equal(a, b)


def test_attend_decode_clamps_the_write_at_max_len(qwen_layer):
    """`dynamic_update_slice_in_dim` clamps its start so that the update
    fits: at length >= max_len both packages write the new K/V at
    max_len - 1 and attend to every position."""
    cfg, lp, tp = qwen_layer
    rng = np.random.default_rng(3)
    cache = _ref_cache(cfg, rng, 1, 6, 6, False)
    cache = cache._replace(length=jnp.asarray(9, jnp.int32))
    x = jnp.asarray(rng.normal(size=(1, 1, 64)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    want, wc = jax.jit(lambda x, p, c: RA.attend_decode(x, p, cfg, c))(
        x, lp, cache)
    got, gc = A.attend_decode(
        carry(x), tp, cfg, A.KVCache(*(None if a is None else carry(a)
                                       for a in cache)))
    assert int(gc.length) == int(wc.length) == 10
    np.testing.assert_array_equal(f32(gc.k), f32(wc.k))
    np.testing.assert_array_equal(f32(gc.v), f32(wc.v))
    assert not np.array_equal(f32(gc.k)[:, :, 5], f32(cache.k)[:, :, 5])
    np.testing.assert_array_equal(f32(gc.k)[:, :, :5], f32(cache.k)[:, :, :5])
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_ULP,
                               atol=ATTN_ATOL)


# ---------------------------------------------------------------------------
# the model: forward, loss, decode, prefill on the four dense smoke configs
# ---------------------------------------------------------------------------

# one bf16 unit at the logits' size (they lie within +-2); the largest
# difference seen: 4.9e-4 (forward), 0 (decode), 6e-8 (prefill, f32)
MODEL_ATOL = 2.0 ** -7


def _ref_outputs(rcfg):
    """One compiled function of the reference's forward, loss, decode (3
    steps from an empty cache, bf16 and int8, max_len 16) and prefill (8
    tokens): one compile per config."""
    rm = ref_get_model(rcfg)
    kv = {k: ref_get_model(dataclasses.replace(rcfg, kv_cache_dtype=k))
          for k in ("bf16", "int8")}

    def run(rp, batch):
        out = {"forward": rm.forward(rp, batch),
               "loss": rm.loss_fn(rp, batch),
               "prefill": ref_prefill(rp, batch["tokens"][:, :8], rcfg, 16)}
        for k, m in kv.items():
            state = m.init_decode_state(2, 16)
            out[f"init_{k}"] = state
            steps = []
            for t in range(3):
                logits, state = m.decode_step(rp, batch["tokens"][:, t], state)
                steps.append((logits, state))
            out[f"decode_{k}"] = steps
        return out
    return jax.jit(run)


@pytest.fixture(scope="module", params=DENSE)
def dense_model(request):
    """A dense smoke model in both packages and the reference's outputs on
    a 2x16 batch (`_ref_outputs`), computed once."""
    arch = request.param
    rcfg = ref_configs.get_smoke_config(arch)
    rp = ref_params(rcfg)
    batch = ref_make_batch(rcfg, 2, 16, seed=4)
    out = _ref_outputs(rcfg)(rp, batch)
    out.update(arch=arch, cfg=configs.get_smoke_config(arch),
               params=carry(rp), batch=batch)
    return out


def _tokens(d):
    return carry(d["batch"])


def test_forward_equals_the_reference(dense_model):
    d = dense_model
    got = get_model(d["cfg"]).forward(d["params"], _tokens(d))
    assert got.shape == (2, 16, d["cfg"].vocab_padded)
    assert got.dtype == torch.float32
    assert_logits_close(got, d["forward"], MODEL_ATOL, 0)


def test_loss_fn_equals_the_reference(dense_model):
    d = dense_model
    loss, metrics = get_model(d["cfg"]).loss_fn(d["params"], _tokens(d))
    want, wm = d["loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    for k in ("loss", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]),
                                   rtol=1e-4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_init_decode_state_and_decode_step_equal_the_reference(
        dense_model, kv):
    """Three steps from an empty cache: logits within MODEL_ATOL with the
    top-1 rule; every step's cache within one bf16 unit (int8: codes within
    one step, scales within one bf16 unit), the length equal."""
    d = dense_model
    cfg = dataclasses.replace(d["cfg"], kv_cache_dtype=kv)
    m = get_model(cfg)
    state = m.init_decode_state(2, 16, device="cpu")
    want0 = d[f"init_{kv}"]
    assert set(state) == set(want0)
    for k, v in want0.items():
        assert tuple(state[k].shape) == tuple(np.shape(v))
        np.testing.assert_array_equal(f32(state[k]), f32(v))
    toks = _tokens(d)["tokens"]
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
        for k in ("k_scale", "v_scale"):
            if kv == "int8":
                np.testing.assert_allclose(f32(state[k]), f32(wstate[k]),
                                           rtol=BF16_ULP, atol=0)


def test_decode_step_leaves_its_input_state_as_it_was(dense_model):
    d = dense_model
    m = get_model(d["cfg"])
    state = m.init_decode_state(2, 16, device="cpu")
    copy = {k: v.clone() for k, v in state.items()}
    m.decode_step(d["params"], _tokens(d)["tokens"][:, 0], state)
    assert all(torch.equal(copy[k], v) for k, v in state.items())


def test_prefill_equals_the_reference(dense_model):
    """Fused prefill of 8 tokens: next-token logits (f32 products, not
    rounded to bf16) with the top-1 rule, the bf16 cache within one unit,
    zeros past the prompt, the length 8."""
    d = dense_model
    want, wstate = d["prefill"]
    got, state = prefill(d["params"], _tokens(d)["tokens"][:, :8], d["cfg"],
                         16)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert_logits_close(got, want, MODEL_ATOL, 0)
    assert int(state["length"]) == int(wstate["length"]) == 8
    for k in ("k", "v"):
        assert state[k].dtype == torch.bfloat16
        np.testing.assert_allclose(f32(state[k]), f32(wstate[k]),
                                   rtol=BF16_ULP, atol=1e-6)
        assert not state[k][:, :, :, 8:].any()


def test_prefill_continues_as_stepwise_decode(dense_model):
    """The reference test's check on the port alone: prefill then one step
    equals 8 decode steps then one step, within atol 0.15 / rtol 0.05, with
    the next token's argmax equal."""
    d = dense_model
    m = get_model(d["cfg"])
    toks = _tokens(d)["tokens"][:1]
    state = m.init_decode_state(1, 16, device="cpu")
    for t in range(8):
        ref, state = m.decode_step(d["params"], toks[:, t], state)
    pf, pstate = prefill(d["params"], toks[:, :8], d["cfg"], 16)
    np.testing.assert_allclose(f32(pf), f32(ref), atol=0.15, rtol=0.05)
    nxt = ref.argmax(-1).to(torch.int32)
    l1, _ = m.decode_step(d["params"], nxt, state)
    l2, _ = m.decode_step(d["params"], nxt, pstate)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))


def test_prefill_refuses_int8_and_recurrent_archs():
    """int8 caches fail `prefill_dense`'s second assertion; the hybrid
    (not ported) goes to `prefill_dense`, as in the reference, and fails
    its first."""
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-4b"),
                              kv_cache_dtype="int8")
    with pytest.raises(AssertionError, match="int8"):
        prefill({}, torch.zeros((1, 4), dtype=torch.int32), cfg, 8)
    with pytest.raises(AssertionError):
        ref_prefill({}, jnp.zeros((1, 4), jnp.int32),
                    ref_configs.get_smoke_config("zamba2-2.7b"), 8)
    with pytest.raises(AssertionError):
        prefill({}, torch.zeros((1, 4), dtype=torch.int32),
                configs.get_smoke_config("zamba2-2.7b"), 8)
