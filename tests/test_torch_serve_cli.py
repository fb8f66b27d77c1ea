"""The port's serve command line against the reference's.

The README's main-path argv (``--continuous --paged --chunked-prefill
--kv-posit posit16 --decode-kernel fused``) and every other mode (the
one-shot engine, linear or paged; the dense-cache scheduler; the
unchunked paged scheduler) go through both ``main``s at reduced width,
on the dense (phi3-medium-14b) and MLA (minicpm3-4b) lanes.  The
reference random-inits from ``PRNGKey(0)``; the family's ``init_params``
in the port is replaced by those weights carried across with
``weights.params_from_jax``, since the two RNG streams differ.  Greedy
tokens, and each request's queueing delay where the mode has one, must
be equal.  The one-shot paths of internvl2-1b (its visual prefix) and
whisper-tiny (its encoder frames) draw their extra input from the same
seeded stream and give the reference's tokens, and so do hymba-1.5b's
and rwkv6-7b's; the argv the reference refuses, the port refuses too,
``--continuous`` outside the transformer family included.
"""

import numpy as np
import pytest
import torch

import jax

from repro import configs as RCFG
from repro.launch import serve as ref_serve
from repro.models import get_family
from repro_torch import configs as TCFG
from repro_torch.launch import serve
from repro_torch.models import get_family as port_family
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
    monkeypatch.setattr(port_family(TCFG.get_config(arch)), "init_params",
                        lambda cfg, seed, device: params_from_jax(rp, cfg, device=device))


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
    """The one-shot paths that take an extra input draw it after the
    prompts, as the reference's do, and return the reference ``main``'s
    tokens: the visual prefix of a config with visual tokens
    (internvl2-1b) and the encoder frames of whisper-tiny (at posit16
    KV: the cross-attention cache through the codec)."""
    if field == "n_visual_tokens":
        arch, n = "internvl2-1b", ["--batch", "3", "--prompt-len", "16", "--gen", "6"]
    else:
        arch, n = "whisper-tiny", ["--batch", "3", "--prompt-len", "12", "--gen", "7"]
    argv = ["--arch", arch, "--reduced", "--kv-posit", "posit16"] + n
    want = ref_serve.main(argv)
    _reference_weights(monkeypatch, arch)
    got = serve.main(argv + ["--device", "cpu"])
    assert got.shape == (3, int(n[-1]))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch,flags", [
    ("hymba-1.5b", ["--kv-posit", "posit16", "--prompt-len", "10", "--gen", "7"]),
    ("rwkv6-7b", ["--prompt-len", "16", "--gen", "7"]),
], ids=["hymba", "rwkv6"])
def test_oneshot_families_match_reference(monkeypatch, arch, flags):
    """hymba-1.5b (ring and global caches, SSM state) and rwkv6-7b (the
    recurrent state; its prompt a multiple of the chunk) through both
    one-shot ``main``s: the reference's tokens."""
    argv = ["--arch", arch, "--reduced", "--batch", "3"] + flags
    want = ref_serve.main(argv)
    _reference_weights(monkeypatch, arch)
    got = serve.main(argv + ["--device", "cpu"])
    assert got.shape == (3, 7)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("flags", [["--continuous"], ["--continuous", "--paged"]],
                         ids=["dense", "paged"])
def test_continuous_refused_outside_transformer_family(monkeypatch, flags):
    """The schedulers need the transformer family: both ``main``s raise
    ``ValueError`` on rwkv6-7b."""
    argv = ["--arch", "rwkv6-7b", "--reduced", "--batch", "2", "--prompt-len", "8",
            "--gen", "4"] + flags
    with pytest.raises(ValueError, match="transformer"):
        ref_serve.main(argv)
    _reference_weights(monkeypatch, "rwkv6-7b")
    with pytest.raises(ValueError, match="transformer"):
        serve.main(argv + ["--device", "cpu"])


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
