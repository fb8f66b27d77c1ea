"""The port's serve command line against the reference's.

The README's main-path argv (``--continuous --paged --chunked-prefill
--kv-posit posit16 --decode-kernel fused``) and every other mode (the
one-shot engine, linear or paged; the dense-cache scheduler; the
unchunked paged scheduler) go through both ``main``s at reduced width,
on the dense (phi3-medium-14b) and MLA (minicpm3-4b) lanes.  The
reference random-inits from ``PRNGKey(0)``; the port's ``init_params`` is
replaced by those weights carried across with
``weights.params_from_jax``, since the two RNG streams differ.  Greedy
tokens, and each request's queueing delay where the mode has one, must
be equal.  internvl2-1b's one-shot path draws its visual prefix from
the same seeded stream and gives the reference's tokens; the
encoder-frame input, whose family the port lacks, raises
``NotImplementedError``; the argv the reference refuses, the port
refuses too.
"""
import dataclasses

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

MAIN_PATH = ["--reduced", "--continuous", "--paged", "--chunked-prefill",
             "--kv-posit", "posit16", "--decode-kernel", "fused",
             "--batch", "4", "--n-requests", "8", "--prompt-len", "24",
             "--gen", "8", "--chunk-size", "4", "--block-size", "4"]


@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _reference_weights(monkeypatch, arch):
    """Make the port's launcher build the reference launcher's weights."""
    rc = RCFG.get_config(arch).reduced(compute_dtype="float32")
    rp = jax.tree.map(np.asarray,
                      get_family(rc).init_params(jax.random.PRNGKey(0), rc))
    monkeypatch.setattr(T, "init_params", lambda cfg, seed, device: (
        params_from_jax(rp, cfg, device=device)))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "minicpm3-4b"])
def test_main_path_argv_matches_reference(monkeypatch, arch):
    argv = ["--arch", arch] + MAIN_PATH
    want = ref_serve.main(argv)
    _reference_weights(monkeypatch, arch)
    res = serve.main(argv + ["--device", "cpu"])
    assert res.sched.engine.cfg.kv_posit == "posit16"
    assert res.sched.engine.cfg.paged_attn_kernel == "fused"
    assert {r: c.tokens.tolist() for r, c in res.done.items()} == \
        {r: c.tokens.tolist() for r, c in want.items()}
    assert {r: c.queue_steps for r, c in res.done.items()} == \
        {r: c.queue_steps for r, c in want.items()}
    assert any(c.queue_steps > 0 for c in res.done.values())


def test_defaults_are_the_reference_defaults():
    args = serve.build_parser().parse_args([])
    assert (args.kv_posit, args.decode_kernel) == ("none", "gather")
    assert not (args.continuous or args.paged or args.chunked_prefill)


_MODE_ARGV = ["--reduced", "--kv-posit", "posit16", "--batch", "4",
              "--n-requests", "8", "--prompt-len", "24", "--gen", "8",
              "--chunk-size", "4", "--block-size", "4"]


@pytest.mark.parametrize("arch,flags", [
    ("phi3-medium-14b", ["--ragged"]),                   # the one-shot engine
    ("phi3-medium-14b", ["--ragged", "--paged", "--decode-kernel", "fused"]),
    ("phi3-medium-14b", ["--continuous"]),               # dense-cache scheduler
    ("minicpm3-4b", ["--continuous"]),
    ("phi3-medium-14b", ["--continuous", "--paged", "--decode-kernel", "fused"]),
], ids=["one-shot", "one-shot-paged", "dense", "dense-mla", "unchunked"])
def test_every_mode_matches_reference(monkeypatch, arch, flags):
    argv = ["--arch", arch] + _MODE_ARGV + flags
    want = ref_serve.main(argv)
    _reference_weights(monkeypatch, arch)
    got = serve.main(argv + ["--device", "cpu"])
    if "--continuous" not in flags:
        assert isinstance(got, np.ndarray) and got.shape == (4, 8)
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    assert got.sched.paged == ("--paged" in flags) and not got.sched.chunked
    assert {r: c.tokens.tolist() for r, c in got.done.items()} == \
        {r: c.tokens.tolist() for r, c in want.items()}
    assert {r: c.queue_steps for r, c in got.done.items()} == \
        {r: c.queue_steps for r, c in want.items()}


@pytest.mark.parametrize("field", ["n_visual_tokens", "family"],
                         ids=["visual", "frames"])
def test_unported_modes_raise(monkeypatch, field):
    """The one-shot path of a config with a visual prefix (internvl2-1b)
    draws the patch embeddings after the prompts, as the reference's
    does, and returns the reference ``main``'s tokens; encoder frames
    (whisper) still raise, naming the ROADMAP item."""
    if field == "n_visual_tokens":
        argv = ["--arch", "internvl2-1b", "--reduced", "--kv-posit", "posit16",
                "--batch", "3", "--prompt-len", "16", "--gen", "6"]
        want = ref_serve.main(argv)
        _reference_weights(monkeypatch, "internvl2-1b")
        got = serve.main(argv + ["--device", "cpu"])
        assert got.shape == (3, 6)
        np.testing.assert_array_equal(got, np.asarray(want))
        return
    config = serve.model_config
    monkeypatch.setattr(serve, "model_config", lambda args: dataclasses.replace(
        config(args), family="whisper"))
    monkeypatch.setattr(T, "init_params", lambda cfg, seed, device: {})
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        serve.main(["--reduced", "--device", "cpu"])


@pytest.mark.parametrize("flags", [
    ["--prefix-cache"],
    ["--chunked-prefill", "--continuous"],
    ["--deadline-ms", "100"],
    ["--decode-kernel", "fused", "--continuous"],
], ids=["prefix-cache", "chunked-unpaged", "deadline", "fused-unpaged"])
def test_reference_refusals_exit_with_status_2(flags):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--reduced", "--device", "cpu"] + flags)
    assert exc.value.code == 2
