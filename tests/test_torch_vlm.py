"""The port's VLM (paligemma: the image prefix of `repro_torch.models.lm`)
against the JAX package on the CPU.

Weights come across from the reference (`params_from_numpy`); inputs
from `numpy.random.default_rng` seeds (`make_batch` draws the patch
embeddings).  The reference is held compiled (`jax.jit`), as for the
dense decoders (`tests/test_torch_lm.py`).  Logits are held at
MODEL_ATOL (2^-7) with the top-1 rule unless a case states its own
tolerance.  As in the reference, the VLM's prefill and serving are
text-only (ROADMAP, "Reference defects the port copies").
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
from repro.models import attention as RA
from repro.models import lm as RL
from repro.models.registry import get_model as ref_get_model
from repro.quant import range_lm as ref_range_lm
from repro_torch import configs
from repro_torch.data.batches import make_batch
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import lm as L
from repro_torch.models.registry import get_model
from repro_torch.quant import range_lm
from repro_torch.serve.prefill import prefill
from test_torch_lm import (BF16_ULP, MODEL_ATOL, _ref_outputs, _ref_specs,
                           _specs, assert_logits_close, carry, f32,
                           ref_params)
from test_torch_lm_serve import _generate
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "paligemma-3b"


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_vlm_param_specs_equal_the_reference(smoke):
    """Shapes, logical axes and init kinds leaf for leaf, and the
    abstract shape tree (nothing allocated)."""
    get = configs.get_smoke_config if smoke else configs.get_config
    rget = ref_configs.get_smoke_config if smoke else ref_configs.get_config
    m, rm = get_model(get(ARCH)), ref_get_model(rget(ARCH))
    want = _ref_specs(rm.param_specs())
    assert _specs(m.param_specs()) == want
    axes = dict(C.tree_items(m.param_axes(),
                             is_leaf=lambda x: isinstance(x, tuple)))
    assert {"/".join(p): a for p, a in axes.items()} == \
        {k: v[1] for k, v in want.items()}
    shapes = dict(C.tree_items(L.abstract_params(get(ARCH)),
                               is_leaf=lambda x: isinstance(x, tuple)))
    assert {"/".join(p): s for p, (s, _) in shapes.items()} == \
        {k: v[0] for k, v in want.items()}


def test_make_batch_draws_the_reference_patch_embeds():
    cfg = configs.get_smoke_config(ARCH)
    got = make_batch(cfg, 2, 16, seed=5, device="cpu")
    want = ref_make_batch(ref_configs.get_smoke_config(ARCH), 2, 16, seed=5)
    assert set(got) == set(want) == {"tokens", "labels", "patch_embeds"}
    assert got["patch_embeds"].dtype == torch.float32
    assert tuple(got["patch_embeds"].shape) == (2, cfg.n_image_tokens,
                                                cfg.d_model)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("S,prefix", [(8, 4), (12, 0), (6, 6)])
def test_prefix_mask_equals_the_reference(S, prefix):
    """`_causal_mask` with a prefix (the reference's
    `test_paligemma_prefix_lm_mask` case among them), tolerance 0."""
    got = A._causal_mask(S, 0, prefix=prefix).numpy()
    np.testing.assert_array_equal(got, np.asarray(RA._causal_mask(
        S, 0, prefix=prefix)))
    if (S, prefix) == (8, 4):
        assert got[0, 3] and not got[4, 5] and got[6, 2]


def test_embed_writes_the_patch_embeds_over_the_prefix():
    """`_embed` with patch embeddings: the reference's jitted values at
    tolerance 0 (positions 0..P-1 the bf16 patch embeddings, unscaled;
    the rest the scaled token embeddings)."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg, seed=2)
    batch = ref_make_batch(rcfg, 2, 16, seed=3)
    want = jax.jit(lambda p, t, e: RL._embed(p, t, rcfg, e))(
        rp, batch["tokens"], batch["patch_embeds"])
    tb = carry(batch)
    got = L._embed(carry(rp), tb["tokens"], cfg, tb["patch_embeds"])
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(f32(got), f32(want))
    n = cfg.n_image_tokens
    np.testing.assert_array_equal(
        f32(got[:, :n]), f32(tb["patch_embeds"].to(torch.bfloat16)))
    np.testing.assert_array_equal(f32(got[:, n:]), f32(L._embed(
        carry(rp), tb["tokens"], cfg)[:, n:]))


@pytest.fixture(scope="module")
def vlm_model():
    """paligemma-smoke in both packages and the reference's compiled
    outputs on a 2x16 batch with 8 patch embeddings
    (`test_torch_lm._ref_outputs`: forward and loss with the image, 3
    decode steps with bf16 and int8 caches, an 8-token prefill), and its
    forward without the patch embeddings."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg)
    batch = ref_make_batch(rcfg, 2, 16, seed=4)
    out = _ref_outputs(rcfg)(rp, batch)
    out["forward_text"] = jax.jit(ref_get_model(rcfg).forward)(
        rp, {"tokens": batch["tokens"]})
    out.update(cfg=configs.get_smoke_config(ARCH), rcfg=rcfg, rparams=rp,
               params=carry(rp), batch=batch)
    return out


def test_forward_with_patch_embeds_equals_the_reference(vlm_model):
    d = vlm_model
    got = get_model(d["cfg"]).forward(d["params"], carry(d["batch"]))
    assert got.shape == (2, 16, d["cfg"].vocab_padded)
    assert got.dtype == torch.float32
    assert_logits_close(got, d["forward"], MODEL_ATOL, 0)


def test_forward_without_patch_embeds_equals_the_reference(vlm_model):
    """No image: the token embeddings throughout, the prefix still
    attending bidirectionally (the reference's `_run_blocks`)."""
    d = vlm_model
    toks = carry(d["batch"])["tokens"]
    got = get_model(d["cfg"]).forward(d["params"], {"tokens": toks})
    assert_logits_close(got, d["forward_text"], MODEL_ATOL, 0)
    # the prefix mask acts without an image too
    causal = L.forward(d["params"], toks, dataclasses.replace(
        d["cfg"], n_image_tokens=0))
    assert float((causal - got).abs().max()) > 1e-3


def test_loss_fn_equals_the_reference(vlm_model):
    """The forward value with the image, rtol 1e-4 as the dense
    decoders' test."""
    d = vlm_model
    loss, metrics = get_model(d["cfg"]).loss_fn(d["params"], carry(d["batch"]))
    want, wm = d["loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    for k in ("loss", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]),
                                   rtol=1e-4)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_step_equals_the_reference(vlm_model, kv):
    """Three text steps from an empty cache: logits within MODEL_ATOL with
    the top-1 rule, the bf16 cache within one bf16 unit (int8 codes
    within one step), the length equal."""
    d = vlm_model
    m = get_model(dataclasses.replace(d["cfg"], kv_cache_dtype=kv))
    state = m.init_decode_state(2, 16, device="cpu")
    assert set(state) == set(d[f"init_{kv}"])
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


def test_prefill_is_text_only_as_the_reference(vlm_model):
    """The fused prefill of 8 tokens equals the reference's (next-token
    logits at MODEL_ATOL with the top-1 rule, the cache within one bf16
    unit, the length 8), and, like it, embeds text only under a causal
    mask: its logits are the causal text-only forward's, not the
    prefix-LM forward's."""
    d = vlm_model
    toks = carry(d["batch"])["tokens"][:, :8]
    want, wstate = d["prefill"]
    got, state = prefill(d["params"], toks, d["cfg"], 16)
    assert_logits_close(got, want, MODEL_ATOL, 0)
    assert int(state["length"]) == int(wstate["length"]) == 8
    for k in ("k", "v"):
        np.testing.assert_allclose(f32(state[k]), f32(wstate[k]),
                                   rtol=BF16_ULP, atol=1e-6)
    causal = L.forward(d["params"], toks, dataclasses.replace(
        d["cfg"], n_image_tokens=0))[:, -1]
    prefix_lm = L.forward(d["params"], toks, d["cfg"])[:, -1]
    assert_logits_close(got, causal, MODEL_ATOL, 0)
    assert float((got - prefix_lm).abs().max()) > 1e-3


def test_decode_matches_forward_text_only_at_the_reference_criterion():
    """`tests/test_encdec_vlm.py::test_paligemma_decode_matches_forward_text_only`
    on the port: its parameters (`init_params(PRNGKey(6))`, carried) and
    tokens, n_image_tokens 0; 8 decode steps against the forward, the
    top-1 token equal on at least 85% of positions, and each within
    MODEL_ATOL of the reference's own."""
    rcfg = dataclasses.replace(ref_configs.get_smoke_config(ARCH),
                               n_image_tokens=0)
    cfg = dataclasses.replace(configs.get_smoke_config(ARCH),
                              n_image_tokens=0)
    rm, m = ref_get_model(rcfg), get_model(cfg)
    rp = ref_get_model(ref_configs.get_smoke_config(ARCH)).init_params(
        jax.random.PRNGKey(6))
    params = carry(rp)
    rtoks = ref_make_batch(rcfg, 1, 8, seed=3)["tokens"]
    toks = carry(rtoks)
    full = m.forward(params, {"tokens": toks})
    assert_logits_close(full, jax.jit(rm.forward)(rp, {"tokens": rtoks}),
                        MODEL_ATOL, 0)
    state = m.init_decode_state(1, 16, device="cpu")
    rstate = rm.init_decode_state(1, 16)
    ref_step = jax.jit(rm.decode_step)
    outs = []
    for t in range(8):
        logits, state = m.decode_step(params, toks[:, t], state)
        want, rstate = ref_step(rp, rtoks[:, t], rstate)
        assert_logits_close(logits, want, MODEL_ATOL, 0)
        outs.append(logits.numpy())
    dec = np.stack(outs, axis=1)
    assert (full.numpy().argmax(-1) == dec.argmax(-1)).mean() >= 0.85


def test_image_prefix_changes_suffix_logits_as_the_reference():
    """`tests/test_encdec_vlm.py::test_paligemma_image_prefix_changes_suffix_logits`
    on the port (`init_params(PRNGKey(7))`, a 1x16 batch of seed 1):
    zeroing the patch embeddings moves the suffix logits by more than
    1e-3; both forwards within MODEL_ATOL of the reference's."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    rm, m = ref_get_model(rcfg), get_model(cfg)
    rp = rm.init_params(jax.random.PRNGKey(7))
    params = carry(rp)
    rbatch = ref_make_batch(rcfg, 1, 16, seed=1)
    rzero = dict(rbatch, patch_embeds=jnp.zeros_like(rbatch["patch_embeds"]))
    fwd = jax.jit(rm.forward)
    with_img = m.forward(params, carry(rbatch))
    without = m.forward(params, carry(rzero))
    assert_logits_close(with_img, fwd(rp, rbatch), MODEL_ATOL, 0)
    assert_logits_close(without, fwd(rp, rzero), MODEL_ATOL, 0)
    n = cfg.n_image_tokens
    assert float((with_img[:, n:] - without[:, n:]).abs().max()) > 1e-3


def test_batcher_tokens_equal_the_reference():
    """paligemma-smoke, `init_params(PRNGKey(0))` carried across, 3
    requests of 4-token prompts from `default_rng(0)` on 2 slots, max_new
    8, max_len 64: every generated token and the step count equal
    (tolerance 0)."""
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


def test_main_serves_paligemma_on_the_cpu_when_asked(capsys):
    """`python -m repro_torch.launch.serve --arch paligemma-3b --smoke
    --device cpu` takes the reference CLI's decode steps."""
    want = ref_serve.main(["--arch", ARCH, "--smoke"])
    got = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert got == want == 22
    assert "served 4 requests (32 tokens) in 22 decode steps" in \
        capsys.readouterr().out


def test_static_ranges_on_paligemma_equal_the_reference():
    """`quant.range_lm` takes the VLM through its transformer branch:
    every interval's ends within 1e-6 relative of the reference's, and
    the alpha table equal."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg, seed=1)
    want = ref_range_lm.static_ranges(rp, rcfg)
    got = range_lm.static_ranges(carry(rp), configs.get_smoke_config(ARCH))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose([got[k].lo, got[k].hi], [v.lo, v.hi],
                                   rtol=1e-6)
    assert range_lm.static_alpha_table(
        carry(rp), configs.get_smoke_config(ARCH)) == \
        ref_range_lm.static_alpha_table(rp, rcfg)
