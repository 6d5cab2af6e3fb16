"""The port's RWKV6 (`repro_torch.models.ssm`, the rwkv blocks and
branches, `serve.prefill.prefill_recurrent`) against the JAX package on
the CPU.

Weights come across from the reference (`params_from_numpy`); inputs
from `numpy.random.default_rng` seeds.  The reference is held compiled
(`jax.jit`): XLA hands the norm before the channel mix the first
residual sum unrounded in f32 and the decay's LoRA its mix unrounded,
and rounds every other bf16 op, and the port follows it
(`blocks.rwkv_tmix`, `blocks.rwkv_fwd`).  The WKV is f32: its sums, the
chunked form's cumsum and its einsum contractions run in another order,
so the states and outputs are held within a tolerance scaled by their
largest value.  Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.batches import make_batch as ref_make_batch
from repro.launch import serve as ref_serve
from repro.models import blocks as RB
from repro.models import common as RC
from repro.models import ssm as RS
from repro.models.registry import get_model as ref_get_model
from repro.serve.prefill import prefill as ref_prefill
from repro_torch import configs
from repro_torch.data.batches import make_batch
from repro_torch.launch import serve
from repro_torch.models import blocks as B
from repro_torch.models import ssm
from repro_torch.models.common import tree_items
from repro_torch.models.registry import get_model
from repro_torch.serve.prefill import prefill
from test_torch_lm import (BF16_ULP, MODEL_ATOL, _ref_specs, _specs,
                           assert_logits_close, carry, f32, ref_params)
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "rwkv6-3b"
CPU = torch.device("cpu")
# the WKV in f32 against the reference's, relative to the largest value:
# the per-token scan sums each output over K in another order (seen:
# 8e-8 of the largest output); the chunked form also divides by decay
# products down to e^-70 and takes its cumsum in another order (seen:
# 4e-6)
SCAN_TOL = 2.0 ** -20
CHUNKED_TOL = 2.0 ** -16


def _wkv_inputs(B_, T, H, K, seed, dtype=jnp.float32):
    """r, k, v (in `dtype`), w in (0, 1), u and a nonzero s0, as jnp
    arrays.  The decays are an initialised model's, exp(-exp(z)) with z
    near 0 (`_rwkv_decay`; z's spread is 0.03 at smoke width, 0.11 at
    full width, 0.25 here), so a 64-token chunk's decay product stays
    far above FLT_MIN (`test_wkv6_chunked_keeps_what_the_reference_flushes`
    takes it below)."""
    rng = np.random.default_rng(seed)
    r, k, v = (jnp.asarray(rng.normal(size=(B_, T, H, K)).astype(
        np.float32)).astype(dtype) for _ in range(3))
    w = jnp.asarray(np.exp(-np.exp(rng.normal(0, 0.25, (B_, T, H, K))))
                    .astype(np.float32))
    u = jnp.asarray((0.3 * rng.normal(size=(H, K))).astype(np.float32))
    s0 = jnp.asarray(rng.normal(size=(B_, H, K, K)).astype(np.float32))
    return r, k, v, w, u, s0


def _close_to_max(got, want, tol):
    """got within tol times want's largest magnitude of want."""
    got, want = f32(got), f32(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# ssm: the WKV6 recurrence
# ---------------------------------------------------------------------------

def test_pick_chunk_equals_the_reference():
    for T in (1, 7, 16, 24, 37, 64, 100, 128):
        for chunk in (1, 8, 16, 64, 200):
            assert ssm._pick_chunk(T, chunk) == RS._pick_chunk(T, chunk)


@pytest.mark.parametrize("with_s0", [False, True], ids=["zeros", "s0"])
@pytest.mark.parametrize("T", [1, 5, 16, 37])
def test_wkv6_scan_equals_the_reference(T, with_s0):
    """Outputs and final state within SCAN_TOL of their largest value."""
    r, k, v, w, u, s0 = _wkv_inputs(2, T, 3, 8, seed=T)
    s0 = s0 if with_s0 else None
    want_out, want_s = jax.jit(RS.wkv6_scan)(r, k, v, w, u, s0)
    got_out, got_s = ssm.wkv6_scan(*map(carry, (r, k, v, w, u)),
                                   None if s0 is None else carry(s0))
    assert got_out.dtype == got_s.dtype == torch.float32
    assert tuple(got_out.shape) == want_out.shape
    _close_to_max(got_out, want_out, SCAN_TOL)
    _close_to_max(got_s, want_s, SCAN_TOL)


@pytest.mark.parametrize("T,chunk", [(16, 8), (24, 16), (37, 64), (40, 16),
                                     (64, 64), (128, 64), (1, 64)],
                         ids=["16by8", "24by16-is-12", "37-prime",
                              "40by16-is-10", "64by64", "128by64", "1"])
def test_wkv6_chunked_equals_the_reference(T, chunk):
    """Chunk sizes that divide T and that do not (the reference's
    `_pick_chunk` takes the largest divisor below), from a nonzero s0:
    outputs and final state within CHUNKED_TOL of their largest value,
    and within CHUNKED_TOL of the port's own per-token scan."""
    r, k, v, w, u, s0 = _wkv_inputs(2, T, 3, 8, seed=100 + T)
    want_out, want_s = jax.jit(lambda *a: RS.wkv6_chunked(
        *a, chunk=chunk))(r, k, v, w, u, s0)
    args = tuple(map(carry, (r, k, v, w, u, s0)))
    got_out, got_s = ssm.wkv6_chunked(*args, chunk=chunk)
    _close_to_max(got_out, want_out, CHUNKED_TOL)
    _close_to_max(got_s, want_s, CHUNKED_TOL)
    scan_out, scan_s = ssm.wkv6_scan(*args)
    _close_to_max(got_out, scan_out, CHUNKED_TOL)
    _close_to_max(got_s, scan_s, CHUNKED_TOL)


def test_wkv6_chunked_keeps_what_the_reference_flushes():
    """A reference defect the port does not copy: XLA on the CPU flushes
    subnormal f32 values to zero, and the chunked form's r_t A_{t-1}
    falls below FLT_MIN (2^-126) where a chunk's decay product A_{t-1}
    does, so the reference drops those terms and departs from its own
    per-token scan.  Decays of e^-1.37 over one 64-token chunk (A_62 =
    e^-86.3) and r, k, v in (-1, 1): the reference's chunked output
    departs from its scan by over a tenth of the largest output; the
    port's stays within CHUNKED_TOL of the reference's scan."""
    rng = np.random.default_rng(11)
    shape = (2, 64, 3, 8)
    r, k, v = (jnp.asarray(rng.uniform(-1, 1, shape).astype(np.float32))
               for _ in range(3))
    w = jnp.full(shape, np.exp(np.float32(-1.37)), jnp.float32)
    u = jnp.asarray((0.3 * rng.normal(size=(3, 8))).astype(np.float32))
    s0 = jnp.asarray(rng.normal(size=(2, 3, 8, 8)).astype(np.float32))
    exact, exact_s = jax.jit(RS.wkv6_scan)(r, k, v, w, u, s0)
    flushed, _ = jax.jit(lambda *a: RS.wkv6_chunked(*a, chunk=64))(
        r, k, v, w, u, s0)
    top = float(np.abs(np.asarray(exact)).max())
    assert float(np.abs(np.asarray(flushed) - np.asarray(exact)).max()) \
        > 0.1 * top
    got, got_s = ssm.wkv6_chunked(*map(carry, (r, k, v, w, u, s0)),
                                  chunk=64)
    _close_to_max(got, exact, CHUNKED_TOL)
    _close_to_max(got_s, exact_s, CHUNKED_TOL)


def test_wkv6_chunked_stages_bf16_inputs_as_the_reference():
    """bf16 r/k/v (the model's dtype), cast to f32 a chunk at a time:
    within CHUNKED_TOL of the reference, and equal to the same values
    given in f32 (the casts are exact)."""
    r, k, v, w, u, s0 = _wkv_inputs(2, 24, 3, 8, seed=7, dtype=jnp.bfloat16)
    want_out, want_s = jax.jit(lambda *a: RS.wkv6_chunked(
        *a, chunk=8))(r, k, v, w, u, s0)
    args = tuple(map(carry, (r, k, v, w, u, s0)))
    assert args[0].dtype == torch.bfloat16
    got_out, got_s = ssm.wkv6_chunked(*args, chunk=8)
    _close_to_max(got_out, want_out, CHUNKED_TOL)
    _close_to_max(got_s, want_s, CHUNKED_TOL)
    f32_out, f32_s = ssm.wkv6_chunked(*(a.float() for a in args[:3]),
                                      *args[3:], chunk=8)
    assert torch.equal(got_out, f32_out) and torch.equal(got_s, f32_s)


# ---------------------------------------------------------------------------
# the RWKV6 block
# ---------------------------------------------------------------------------

def _block_params(rcfg, seed):
    """One layer's parameters (not stacked), normal with std 0.05 and the
    norm weights near 1, as jnp arrays."""
    rng = np.random.default_rng(seed)

    def leaf(s):
        base = 1.0 if s.init == "ones" else 0.0
        return jnp.asarray((base + 0.05 * rng.standard_normal(s.shape))
                           .astype(np.float32))
    return jax.tree.map(leaf, RB.rwkv_specs(rcfg, None),
                        is_leaf=lambda x: isinstance(x, RC.ParamSpec))


def _block_state(rcfg, seed):
    rng = np.random.default_rng(seed)
    D, K = rcfg.d_model, rcfg.rwkv_head_dim

    def bf16(shape):
        return jnp.asarray(rng.normal(size=shape).astype(np.float32)
                           ).astype(jnp.bfloat16)
    return {"s": jnp.asarray(rng.normal(size=(2, D // K, K, K)).astype(
        np.float32)), "x_att": bf16((2, D)), "x_ffn": bf16((2, D))}


@pytest.mark.parametrize("T,chunked,with_state", [
    (8, True, False), (16, True, False), (40, True, True),
    (1, False, True), (3, False, True)],
    ids=["chunked-8", "chunked-16", "chunked-40-state", "step-1-state",
         "step-3-state"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rwkv_fwd_equals_the_jitted_reference(seed, T, chunked, with_state):
    """rwkv6-smoke's block, chunked (the forward's and prefill's) and per
    token (decode's), from zeros or a carried state.  The port follows
    the jitted reference's roundings but not XLA's own tanh and exp in
    the decay (torch's differ in the last place on most values), so a
    bf16 rounding downstream of the WKV can flip: the output and the
    channel mix's carried token within one bf16 unit at their largest
    magnitude (BF16_ULP times it), at most 2% of the outputs apart
    (seen: up to 13 of 1,024 outputs and 14 of 128 carried tokens, by
    one unit, in 4 of these 15 cases; 0 in the others; a flipped unit in
    the residual sum moves its row's norm), the time mix's carried token
    equal, the WKV state within CHUNKED_TOL of its largest value."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    rp = _block_params(rcfg, seed)
    x = jnp.asarray(np.random.default_rng(50 + seed).normal(
        size=(2, T, rcfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    st = _block_state(rcfg, 60 + seed) if with_state else None
    want, wst = jax.jit(lambda x, p, s: RB.rwkv_fwd(
        x, p, rcfg, s, chunked=chunked))(x, rp, st)
    got, gst = B.rwkv_fwd(carry(x), carry(rp), cfg,
                          None if st is None else carry(st), chunked=chunked)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    for g, w in ((got, want), (gst["x_ffn"], wst["x_ffn"])):
        assert g.dtype == torch.bfloat16
        _close_to_max(g, w, BF16_ULP)
    assert (f32(got) != f32(want)).mean() <= 0.02
    np.testing.assert_array_equal(f32(gst["x_att"]), f32(wst["x_att"]))
    assert gst["s"].dtype == torch.float32
    _close_to_max(gst["s"], wst["s"], CHUNKED_TOL)


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
def test_rwkv_param_specs_equal_the_reference(smoke):
    """Shapes, logical axes and init kinds leaf for leaf, stacked and
    alone, and the whole model's tree; nothing allocated."""
    get = configs.get_smoke_config if smoke else configs.get_config
    ref_get = (ref_configs.get_smoke_config if smoke
               else ref_configs.get_config)
    cfg, rcfg = get(ARCH), ref_get(ARCH)
    for stacked in (None, cfg.n_layers):
        assert _specs(B.rwkv_specs(cfg, stacked)) == \
            _ref_specs(RB.rwkv_specs(rcfg, stacked))
    got = _specs(get_model(cfg).param_specs())
    assert got == _ref_specs(ref_get_model(rcfg).param_specs())
    assert "blocks/tmix/w_lora_a" in got and "blocks/cmix/w_v" in got


def test_init_params_draws_the_rwkv_tree_on_the_generators_device():
    cfg = configs.get_smoke_config(ARCH)
    m = get_model(cfg)
    a = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    b = m.init_params(torch.Generator(device=CPU).manual_seed(3))
    ref_specs = ref_get_model(ref_configs.get_smoke_config(
        ARCH)).param_specs()
    assert [p for p, _ in tree_items(a)] == [
        tuple(k.key for k in p) for p, _ in
        jax.tree_util.tree_flatten_with_path(
            ref_specs, is_leaf=lambda x: isinstance(x, RC.ParamSpec))[0]]
    for (_, ta), (_, tb) in zip(tree_items(a), tree_items(b)):
        assert torch.equal(ta, tb)
        assert ta.dtype == torch.float32 and ta.device == CPU
    assert torch.equal(a["blocks"]["tmix"]["ln_x"],
                       torch.ones(cfg.n_layers, cfg.d_model))


def test_init_decode_state_equals_the_reference():
    """Keys, shapes, dtypes and zeros; the length as given."""
    rm = ref_get_model(ref_configs.get_smoke_config(ARCH))
    m = get_model(configs.get_smoke_config(ARCH))
    for prefill_len in (0, 5):
        want = rm.init_decode_state(3, 32, prefill_len)
        got = m.init_decode_state(3, 32, prefill_len, device="cpu")
        assert set(got) == set(want) == {"s", "x_att", "x_ffn", "length"}
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape
            assert str(got[k].dtype).split(".")[1] == str(v.dtype)
            np.testing.assert_array_equal(f32(got[k]), f32(v))


# ---------------------------------------------------------------------------
# the RWKV6 decoder: forward, loss, decode, prefill
# ---------------------------------------------------------------------------

def _ref_rwkv_outputs(rcfg):
    """One compiled function of the reference's forward, loss, decode (3
    steps from an empty state) and prefill (8 tokens)."""
    rm = ref_get_model(rcfg)

    def run(rp, batch):
        out = {"forward": rm.forward(rp, batch),
               "loss": rm.loss_fn(rp, batch),
               "prefill": ref_prefill(rp, batch["tokens"][:, :8], rcfg, 16)}
        state = rm.init_decode_state(2, 16)
        steps = []
        for t in range(3):
            logits, state = rm.decode_step(rp, batch["tokens"][:, t], state)
            steps.append((logits, state))
        out["decode"] = steps
        return out
    return jax.jit(run)


@pytest.fixture(scope="module")
def rwkv_model():
    """rwkv6-smoke in both packages and the reference's compiled outputs
    on a 2x16 batch."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rp = ref_params(rcfg)
    batch = ref_make_batch(rcfg, 2, 16, seed=4)
    out = _ref_rwkv_outputs(rcfg)(rp, batch)
    out.update(cfg=configs.get_smoke_config(ARCH), rparams=rp,
               params=carry(rp), batch=batch)
    return out


def _states_close(got, want):
    """The carried tokens within one bf16 unit, the WKV state within
    CHUNKED_TOL of its largest value, the length equal."""
    for k in ("x_att", "x_ffn"):
        np.testing.assert_allclose(f32(got[k]), f32(want[k]), rtol=BF16_ULP,
                                   atol=0)
    _close_to_max(got["s"], want["s"], CHUNKED_TOL)
    assert int(got["length"]) == int(want["length"])


def test_forward_equals_the_reference(rwkv_model):
    """Logits within MODEL_ATOL with the top-1 rule."""
    d = rwkv_model
    got = get_model(d["cfg"]).forward(d["params"], carry(d["batch"]))
    assert got.shape == (2, 16, d["cfg"].vocab_padded)
    assert got.dtype == torch.float32
    assert_logits_close(got, d["forward"], MODEL_ATOL, 0)


def test_loss_fn_equals_the_reference(rwkv_model):
    """rtol 1e-4, as the dense decoders' test."""
    d = rwkv_model
    loss, metrics = get_model(d["cfg"]).loss_fn(d["params"], carry(d["batch"]))
    want, wm = d["loss"]
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-4)
    for k in ("loss", "zloss", "tokens"):
        np.testing.assert_allclose(float(metrics[k]), float(wm[k]),
                                   rtol=1e-4)


def test_decode_step_equals_the_reference(rwkv_model):
    """Three steps from an empty state: logits within MODEL_ATOL with the
    top-1 rule, the state as `_states_close`; the state handed in is
    left as it was."""
    d = rwkv_model
    m = get_model(d["cfg"])
    state = m.init_decode_state(2, 16, device="cpu")
    toks = carry(d["batch"])["tokens"]
    for t, (want, wstate) in enumerate(d["decode"]):
        before = {k: v.clone() for k, v in state.items()}
        logits, new = m.decode_step(d["params"], toks[:, t], state)
        assert all(torch.equal(state[k], v) for k, v in before.items())
        assert_logits_close(logits, want, MODEL_ATOL, 0)
        _states_close(new, wstate)
        state = new
    assert int(state["length"]) == 3


def test_prefill_equals_the_reference(rwkv_model):
    """`prefill` sends rwkv to `prefill_recurrent`: 8 tokens, the
    next-token logits within MODEL_ATOL with the top-1 rule, the state
    as `_states_close`, the length 8."""
    d = rwkv_model
    want, wstate = d["prefill"]
    got, state = prefill(d["params"], carry(d["batch"])["tokens"][:, :8],
                         d["cfg"], 16)
    assert got.dtype == torch.float32
    assert_logits_close(got, want, MODEL_ATOL, 0)
    assert set(state) == set(wstate)
    _states_close(state, wstate)
    assert int(state["length"]) == 8


# ---------------------------------------------------------------------------
# the reference's own model tests, on the port
# ---------------------------------------------------------------------------

def test_forward_and_loss_at_the_reference_criterion():
    """`tests/test_models_smoke.py::test_forward_and_loss[rwkv6-3b]` on
    the port (`init_params(PRNGKey(0))`, carried; `make_batch(cfg, 2,
    16)`): the loss finite, logits of the shape without NaN; and both
    within the reference's own (loss rtol 1e-4, logits MODEL_ATOL with
    the top-1 rule)."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rm, m = ref_get_model(rcfg), get_model(configs.get_smoke_config(ARCH))
    rp = rm.init_params(jax.random.PRNGKey(0))
    params, rbatch = carry(rp), ref_make_batch(rcfg, 2, 16)
    batch = carry(rbatch)
    loss, _ = m.loss_fn(params, batch)
    assert np.isfinite(float(loss))
    logits = m.forward(params, batch)
    assert logits.shape == (2, 16, rcfg.vocab_padded)
    assert not torch.isnan(logits).any()
    np.testing.assert_allclose(float(loss),
                               float(jax.jit(rm.loss_fn)(rp, rbatch)[0]),
                               rtol=1e-4)
    assert_logits_close(logits, jax.jit(rm.forward)(rp, rbatch), MODEL_ATOL,
                        0)


def test_decode_step_shapes_at_the_reference_criterion():
    """`tests/test_models_smoke.py::test_decode_step_shapes[rwkv6-3b]` on
    the port (`init_params(PRNGKey(2))`, a state of 2 x 32, token 0
    twice): logits of the shape without NaN, the length 1 then 2; each
    step's logits within MODEL_ATOL of the reference's."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rm, m = ref_get_model(rcfg), get_model(configs.get_smoke_config(ARCH))
    rp = rm.init_params(jax.random.PRNGKey(2))
    params = carry(rp)
    state = m.init_decode_state(2, 32, device="cpu")
    rstate = rm.init_decode_state(2, 32)
    tok = torch.zeros(2, dtype=torch.int32)
    ref_step = jax.jit(rm.decode_step)
    for t in (1, 2):
        logits, state = m.decode_step(params, tok, state)
        want, rstate = ref_step(rp, jnp.zeros((2,), jnp.int32), rstate)
        assert logits.shape == (2, rcfg.vocab_padded)
        assert not torch.isnan(logits).any()
        assert int(state["length"]) == t
        assert_logits_close(logits, want, MODEL_ATOL, 0)


def test_decode_matches_forward_at_the_reference_criterion():
    """`tests/test_models_smoke.py::test_decode_matches_forward[rwkv6-3b]`
    on the port: its parameters (`init_params(PRNGKey(3))`, carried) and
    tokens, 8 decode steps against the forward at atol 0.18 / rtol 0.05,
    the top-1 token equal on at least 85% of positions; the forward and
    each step within MODEL_ATOL of the reference's own."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rm, m = ref_get_model(rcfg), get_model(configs.get_smoke_config(ARCH))
    rp = rm.init_params(jax.random.PRNGKey(3))
    params = carry(rp)
    rtoks = ref_make_batch(rcfg, 1, 8, seed=7)["tokens"]
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
    np.testing.assert_allclose(dec, full.numpy(), atol=0.18, rtol=0.05)
    assert (full.numpy().argmax(-1) == dec.argmax(-1)).mean() >= 0.85


def test_prefill_matches_stepwise_decode_at_the_reference_criterion():
    """`tests/test_serve_elastic.py::test_prefill_matches_stepwise_decode[rwkv6-3b]`
    on the port (`init_params(PRNGKey(0))`, `make_batch(cfg, 1, 8,
    seed=4)`): prefill against 8 decode steps at atol 0.15 / rtol 0.05,
    the lengths equal, the next token's argmax equal from either state;
    the prefill's logits within MODEL_ATOL of the reference's and its
    state as `_states_close`."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    cfg = configs.get_smoke_config(ARCH)
    rm, m = ref_get_model(rcfg), get_model(cfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    params = carry(rp)
    rtoks = ref_make_batch(rcfg, 1, 8, seed=4)["tokens"]
    toks = carry(rtoks)
    state = m.init_decode_state(1, 16, device="cpu")
    for t in range(8):
        logits_ref, state = m.decode_step(params, toks[:, t], state)
    logits_pf, state_pf = prefill(params, toks, cfg, max_len=16)
    np.testing.assert_allclose(logits_pf.numpy(), logits_ref.numpy(),
                               atol=0.15, rtol=0.05)
    assert int(state_pf["length"]) == int(state["length"]) == 8
    nxt = logits_ref.argmax(-1).to(torch.int32)
    l1, _ = m.decode_step(params, nxt, state)
    l2, _ = m.decode_step(params, nxt, state_pf)
    assert torch.equal(l1.argmax(-1), l2.argmax(-1))
    want, wstate = jax.jit(lambda p, t: ref_prefill(p, t, rcfg, 16))(
        rp, rtoks)
    assert_logits_close(logits_pf, want, MODEL_ATOL, 0)
    _states_close(state_pf, wstate)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def example():
    """rwkv6-smoke's `init_params(PRNGKey(0))` and the example's 4
    prompts of 4 tokens from `default_rng(0)`."""
    rcfg = ref_configs.get_smoke_config(ARCH)
    rm = ref_get_model(rcfg)
    rp = rm.init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, rcfg.vocab_size, size=4))
               for _ in range(4)]
    return rm, rp, carry(rp), prompts


def _serve(batcher, request_cls, prompts, max_new=8):
    """The example's loop (admit, step, until every request is done),
    recording each step's logits and, for every token sampled, its
    (step, slot, request): (tokens of each request, steps, logits a
    step as numpy f32, sampled)."""
    reqs = [request_cls(i, p, max_new) for i, p in enumerate(prompts)]
    step, logs, sampled = batcher._step, [], []

    def recording(params, tokens, state):
        logits, state = step(params, tokens, state)
        logs.append(f32(logits))
        return logits, state
    batcher._step = recording
    pending, steps = list(reqs), 0
    while pending or batcher.active():
        while pending and batcher.admit(pending[0]):
            pending.pop(0)
        before = [(r, len(r.generated)) for r in batcher.slot_req if r]
        slots = {id(r): s for s, r in enumerate(batcher.slot_req) if r}
        batcher.step()
        sampled += [(steps, slots[id(r)], r.rid) for r, n in before
                    if len(r.generated) > n]
        steps += 1
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], steps, logs, sampled


def _serve_both(example, prompts, slots):
    """The reference's and the port's batcher on `prompts` (max_len 64):
    their tokens, the step count (equal in both), and the (request,
    position) of each token not compared: from the first token a slot
    samples at a near tie (the reference's top-2 margin at most twice
    the two packages' largest logit difference at that step, so that the
    port may take the other token) on, that slot's tokens follow another
    history in each package.  Every step's logits of a slot not forked
    are within MODEL_ATOL of the reference's."""
    rm, rp, tp, _ = example
    ref = _serve(ref_serve.ContinuousBatcher(rm, rp, slots, 64),
                 ref_serve.Request, prompts)
    port = _serve(serve.ContinuousBatcher(
        get_model(configs.get_smoke_config(ARCH)), tp, slots, 64),
        serve.Request, prompts)
    assert port[1] == ref[1] and port[3] == ref[3]
    forked, skipped, pos = set(), set(), {}
    for t, s, rid in ref[3]:
        pos[rid] = pos.get(rid, -1) + 1
        top2 = np.sort(ref[2][t][s])[-2:]
        if s not in forked:
            diff = np.abs(port[2][t][s] - ref[2][t][s]).max()
            assert diff <= MODEL_ATOL, (t, s, diff)
            if top2[1] - top2[0] <= 2 * diff:
                forked.add(s)
        if s in forked:
            skipped.add((rid, pos[rid]))
    return ref[0], port[0], ref[1], skipped


def _assert_tokens_agree(ref, port, skipped):
    for rid, (want, got) in enumerate(zip(ref, port)):
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a == b or (rid, i) in skipped, (rid, i, got, want)


def test_batcher_tokens_equal_the_reference(example):
    """The example's setup (4 requests, 2 slots, max_new 8, max_len 64):
    the step count equal, every step's logits within MODEL_ATOL, and
    every generated token equal (tolerance 0) but those a slot samples
    from a near tie of the reference's logits on (`_serve_both`).  The
    reference's decay takes XLA's own tanh and exp, which the port does
    not copy (torch's differ in the last place), so the WKV state parts
    in the last f32 place from the first step (9e-9) and a bf16 logit
    can part by a unit from step 9; in this run request 2's first token
    meets an exact tie of the reference's (top-2 margin 0), and its 8
    tokens are left out: 24 of 32 compared, all equal."""
    ref, port, steps, skipped = _serve_both(example, example[3], 2)
    assert steps == 22 and all(len(g) == 8 for g in port)
    _assert_tokens_agree(ref, port, skipped)
    assert len(skipped) <= 8


def test_unclaimed_slot_state_makes_tokens_depend_on_the_slots_past(
        example):
    """The batcher never clears a slot on admission, so a request starts
    from the WKV state and carried tokens its slot's last occupant left
    (`test_torch_lm_serve.py::test_shared_length_makes_tokens_depend_on_the_slots_past`
    for the transformer's K/V): one slot, the third prompt served alone
    and after the first two gives other tokens, in both packages, and
    the port's equal the reference's as `_serve_both` compares them."""
    prompts = example[3]
    ref_alone, port_alone, _, skip_alone = _serve_both(
        example, [prompts[2]], 1)
    ref_after, port_after, _, skip_after = _serve_both(
        example, prompts[:3], 1)
    _assert_tokens_agree(ref_alone, port_alone, skip_alone)
    _assert_tokens_agree(ref_after, port_after, skip_after)
    assert ref_alone[0] != ref_after[2]
    assert port_alone[0] != port_after[2]


def test_main_serves_rwkv_on_the_cpu_when_asked(capsys):
    """`python -m repro_torch.launch.serve --arch rwkv6-3b --smoke
    --device cpu` takes the reference CLI's decode steps."""
    want = ref_serve.main(["--arch", ARCH, "--smoke"])
    got = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    assert got == want == 22
    assert "served 4 requests (32 tokens) in 22 decode steps" in \
        capsys.readouterr().out

