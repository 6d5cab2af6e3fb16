"""The port's continuous batcher (`repro_torch.launch.serve`) against the
JAX package's on the CPU: generated tokens equal, token for token.

Both batchers keep one decode position for every slot and never clear
a slot on admission (ROADMAP, "Reference defects"), so a request's
tokens depend on what its slot served before; the tests pin that in both
packages rather than expecting each request to depend on its own prompt
only.  The weights are the example's (`examples/serve_quantized.py`:
`init_params(PRNGKey(0))` of qwen3-smoke), carried across.
"""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models.registry import get_model as ref_get_model
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.registry import get_model
from test_torch_lm import carry
from _torch_threads import one_torch_thread  # noqa: F401

# the reference's tokens for the third prompt of `default_rng(0)` on one
# slot (max_len 64, max_new 8): served alone, and after the first two
ALONE = [86, 151, 64, 347, 319, 117, 345, 324]
AFTER_TWO = [53, 208, 194, 237, 50, 15, 347, 335]


@pytest.fixture(scope="module")
def example():
    cfg = ref_smoke_config("qwen3-4b")
    rp = ref_get_model(cfg).init_params(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=4))
               for _ in range(4)]
    return cfg, rp, carry(rp), prompts


def _generate(batcher_cls, request_cls, bundle, params, prompts, slots,
              max_len, max_new=8):
    """The example's `generate`: admit, step, until every request is done;
    the tokens of each request and the decode steps taken."""
    batcher = batcher_cls(bundle, params, slots, max_len)
    reqs = [request_cls(i, p, max_new) for i, p in enumerate(prompts)]
    pending, steps = list(reqs), 0
    while pending or batcher.active():
        while pending and batcher.admit(pending[0]):
            pending.pop(0)
        batcher.step()
        steps += 1
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], steps


def _both(example, kv, prompts, slots, max_len):
    cfg, rp, tp, _ = example
    ref = _generate(ref_serve.ContinuousBatcher, ref_serve.Request,
                    ref_get_model(dataclasses.replace(cfg,
                                                      kv_cache_dtype=kv)),
                    rp, prompts, slots, max_len)
    port = _generate(serve.ContinuousBatcher, serve.Request,
                     get_model(dataclasses.replace(get_smoke_config(
                         "qwen3-4b"), kv_cache_dtype=kv)),
                     tp, prompts, slots, max_len)
    return ref, port


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_batcher_tokens_equal_the_reference(example, kv):
    """The example's setup: 4 requests, 2 slots, max_new 8, max_len 64;
    tolerance 0 on every generated token and on the step count."""
    ref, port = _both(example, kv, example[3], 2, 64)
    assert port == ref
    assert port[1] == 22 and all(len(g) == 8 for g in port[0])


def test_shared_length_makes_tokens_depend_on_the_slots_past(example):
    """One slot: the third prompt served alone and served after the first
    two gives other tokens, in both packages, the same ones."""
    prompts = example[3]
    (ref_alone, _), (port_alone, _) = _both(example, "bf16", [prompts[2]],
                                            1, 64)
    (ref_after, _), (port_after, _) = _both(example, "bf16", prompts[:3],
                                            1, 64)
    assert ref_alone == port_alone == [ALONE]
    assert ref_after[2] == port_after[2] == AFTER_TWO
    assert ALONE != AFTER_TWO


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_decode_past_max_len_clamps_as_the_reference(example, kv):
    """max_len 8 with 22 steps: from step 8 on every write lands on the
    last position (the reference's clamped dynamic_update_slice); the
    tokens stay equal."""
    ref, port = _both(example, kv, example[3][:3], 2, 8)
    assert port == ref and port[1] > 8


def test_main_takes_the_reference_steps(capsys):
    """`python -m repro_torch.launch.serve --smoke --device cpu` serves the
    reference CLI's requests in the same number of decode steps."""
    want = ref_serve.main(["--arch", "qwen3-4b", "--smoke"])
    got = serve.main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu"])
    assert got == want == 22
    out = capsys.readouterr().out
    assert "served 4 requests (32 tokens) in 22 decode steps" in out
    assert serve.main(["--arch", "qwen3-4b", "--smoke", "--quant-bits", "8",
                       "--requests", "3", "--max-new", "5",
                       "--device", "cpu"]) == 16
    assert "serving with 8-bit weights" in capsys.readouterr().out


def test_main_runs_on_the_card_unless_asked(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-4b", "--smoke"])
