"""The port's other transformer-family architectures against the
reference: gemma-7b (GeGLU, ``norm_plus_one``, ``scale_embed``, tied
unembedding, head_dim 256 at full width), granite-34b (MQA),
internvl2-1b (tied, its visual prefix) and the MoE feed-forward of
granite-moe-3b-a800m and dbrx-132b.

At reduced width in f32 with the reference's parameters carried over by
``weights.params_from_jax``: ``Engine.generate`` on a ragged batch (pad
tokens take MoE capacity) gives the reference's greedy tokens at f32,
posit16 and posit8 KV, prefill logits within 1e-4 (the tolerance of
``tests/test_torch_engine.py``), and the same tokens from
``generate_stepwise`` and from a paged engine.  internvl's ``visual``
patch embeddings replace the front of the sequence exactly as the
reference's do (the prompt's last nv tokens drop out).
"""
import numpy as np
import pytest
import torch

import jax

from repro import configs as RCFG
from repro.models import get_family
from repro.runtime.engine import Engine as RefEngine
from repro_torch import configs as TCFG
from repro_torch.models import transformer as T
from repro_torch.runtime.engine import Engine
from repro_torch.weights import params_from_jax

ARCHS = ["gemma-7b", "granite-34b", "internvl2-1b", "granite-moe-3b-a800m",
         "dbrx-132b"]
KVS = [None, "posit16", "posit8"]
KV_IDS = ["f32", "posit16", "posit8"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _cfgs(arch, kv=None):
    return (RCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv),
            TCFG.get_config(arch).reduced(compute_dtype="float32", kv_posit=kv))


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        rc, tc = _cfgs(arch)
        rp = get_family(rc).init_params(jax.random.PRNGKey(0), rc)
        _PARAMS[arch] = (rp, params_from_jax(jax.tree.map(np.asarray, rp), tc,
                                             device="cpu"))
    return _PARAMS[arch]


def _prompts(cfg, lens, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, n).tolist() for n in lens]


def test_registry_serves_every_transformer_architecture():
    transformers = tuple(a for a in RCFG.ARCH_IDS
                         if RCFG.get_config(a).family == "transformer")
    assert set(transformers) <= set(TCFG.ARCH_IDS)
    assert TCFG.ARCH_IDS == RCFG.ARCH_IDS      # the other families too, in order
    for arch in TCFG.ARCH_IDS:
        assert TCFG.get_config(arch).__dict__ == RCFG.get_config(arch).__dict__


@pytest.mark.parametrize("kv", KVS, ids=KV_IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_reference(arch, kv):
    """A ragged batch for 10 tokens: linear, stepwise and paged engines
    give the reference's greedy tokens; prefill logits within 1e-4."""
    rc, tc = _cfgs(arch, kv)
    rp, tp = _params(arch)
    prompts = _prompts(tc, (5, 11, 3), seed=1)
    ref = RefEngine(rc, rp, max_len=24).generate(prompts, 10)

    eng = Engine(tc, tp, max_len=24, device="cpu")
    got = eng.generate(prompts, 10)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_allclose(got.prefill_logits, ref.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(eng.generate_stepwise(prompts, 10).tokens,
                                  got.tokens)
    pag = Engine(tc, tp, max_len=24, paged=True, block_size=4, device="cpu")
    np.testing.assert_array_equal(pag.generate(prompts, 10).tokens, ref.tokens)


@pytest.mark.parametrize("paged", [False, True], ids=["linear", "paged"])
@pytest.mark.parametrize("kv", ["posit16", None], ids=["posit16", "f32"])
def test_visual_prefix_matches_reference(kv, paged):
    """internvl's (B, nv, D) patch embeddings through ``generate`` on an
    equal-length batch: tokens equal the reference's, prefill logits
    within 1e-4."""
    rc, tc = _cfgs("internvl2-1b", kv)
    rp, tp = _params("internvl2-1b")
    rng = np.random.default_rng(4)
    prompts = rng.integers(1, tc.vocab, size=(2, 12))
    visual = rng.standard_normal((2, tc.n_visual_tokens, tc.d_model)).astype(np.float32)
    ref = RefEngine(rc, rp, max_len=24).generate(prompts, 8, visual=jax.numpy.asarray(visual))
    eng = Engine(tc, tp, max_len=24, paged=paged, block_size=4, device="cpu")
    got = eng.generate(prompts, 8, visual=torch.from_numpy(visual))
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    np.testing.assert_allclose(got.prefill_logits, ref.prefill_logits,
                               rtol=1e-4, atol=1e-4)
    without = eng.generate(prompts, 8)
    assert not np.array_equal(without.prefill_logits, got.prefill_logits)


def test_visual_prefix_drops_the_prompts_last_tokens():
    """The patch embeddings take the sequence's front and the prompt's
    last nv embeddings drop (the reference's stub, copied as it is), so
    the last nv prompt tokens change nothing."""
    _, tc = _cfgs("internvl2-1b")
    _, tp = _params("internvl2-1b")
    nv = tc.n_visual_tokens
    rng = np.random.default_rng(9)
    tokens = torch.as_tensor(rng.integers(1, tc.vocab, size=(2, 12)))
    other = tokens.clone()
    other[:, -nv:] = torch.as_tensor(rng.integers(1, tc.vocab, size=(2, nv)))
    visual = torch.as_tensor(rng.standard_normal((2, nv, tc.d_model)), dtype=torch.float32)
    x = T._embed(tp, tokens, tc, visual)
    assert x.shape == (2, 12, tc.d_model)
    torch.testing.assert_close(x[:, :nv], visual, rtol=0, atol=0)
    torch.testing.assert_close(x[:, nv:], T._embed(tp, tokens, tc)[:, :12 - nv],
                               rtol=0, atol=0)
    _, a = T.prefill(tp, tokens, tc, visual)
    _, b = T.prefill(tp, other, tc, visual)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
