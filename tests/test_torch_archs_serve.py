"""The port's three schedulers on the MoE lane (granite-moe-3b-a800m)
and the chunked one on gemma-7b, through both ``serve.main``s.

At reduced width in f32, with the reference launcher's weights carried
over by ``weights.params_from_jax``: the chunked paged scheduler (with
the prefix cache and without), the unchunked paged scheduler (each with
the fused and the gather decode) and the dense-cache scheduler give the
reference's greedy tokens and per-request queueing delays on the same
seeded Poisson trace.  MoE capacity depends on the length each call
passes (a chunk, a whole prompt, one decode token), so each scheduler
is held to the reference's own outputs on its own path.
"""
import numpy as np
import pytest
import torch

import jax

from repro import configs as RCFG
from repro.launch import serve as ref_serve
from repro.models import get_family
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.weights import params_from_jax

TRACE = ["--reduced", "--continuous", "--kv-posit", "posit16", "--batch", "4",
         "--n-requests", "8", "--prompt-len", "24", "--gen", "8", "--chunk-size", "4",
         "--block-size", "4"]
CHUNKED = ["--paged", "--chunked-prefill"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _reference_weights(monkeypatch, arch):
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32")
    rp = jax.tree.map(np.asarray,
                      get_family(rc).init_params(jax.random.PRNGKey(0), rc))
    monkeypatch.setattr(T, "init_params", lambda cfg, seed, device: (
        params_from_jax(rp, cfg, device=device)))


@pytest.mark.parametrize("arch,flags", [
    ("granite-moe-3b-a800m", CHUNKED + ["--prefix-cache", "--prefix-share", "0.5",
                                        "--decode-kernel", "fused"]),
    ("granite-moe-3b-a800m", CHUNKED),
    ("granite-moe-3b-a800m", ["--paged", "--decode-kernel", "fused"]),
    ("granite-moe-3b-a800m", ["--paged"]),
    ("granite-moe-3b-a800m", []),
    ("gemma-7b", CHUNKED + ["--decode-kernel", "fused"]),
], ids=["moe-chunked-prefix-fused", "moe-chunked-gather", "moe-unchunked-fused",
        "moe-unchunked-gather", "moe-dense", "gemma-chunked-fused"])
def test_schedulers_match_reference(monkeypatch, arch, flags):
    argv = ["--arch", arch] + TRACE + flags
    want = ref_serve.main(argv)
    _reference_weights(monkeypatch, arch)
    got = serve.main(argv + ["--device", "cpu"])
    sched = got.sched
    assert sched.paged == ("--paged" in flags)
    assert sched.chunked == ("--chunked-prefill" in flags)
    assert sched.engine.cfg.paged_attn_kernel == (
        "fused" if "fused" in flags else "gather")
    assert {r: c.tokens.tolist() for r, c in got.done.items()} == \
        {r: c.tokens.tolist() for r, c in want.items()}
    assert {r: c.queue_steps for r, c in got.done.items()} == \
        {r: c.queue_steps for r, c in want.items()}
    if "--prefix-cache" in flags:
        assert sched.prefix_hits > 0
