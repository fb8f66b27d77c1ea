"""The sampling contract of the port's ``runtime.engine.sample_token``.

The three properties ``tests/test_engine_properties.py`` pins on the
reference, on seeded cases (``hypothesis`` is not a dependency): a fixed
generator state gives the same tokens (and the same next state) twice;
temperature -> 0+ agrees with greedy argmax, and greedy consumes no
randomness; every sampled id is an int32 in the vocabulary.
"""
import numpy as np
import pytest
import torch

from repro_torch.runtime.engine import sample_token

# (seed, temperature, batch, vocab), drawn once from a seeded stream
_RNG = np.random.default_rng(2024)
CASES = [(int(_RNG.integers(0, 2 ** 31 - 1)), float(_RNG.uniform(0.05, 4.0)),
          int(_RNG.integers(1, 5)), int(_RNG.integers(2, 33))) for _ in range(12)]
IDS = [f"case{i}" for i in range(len(CASES))]


def _logits(seed, b, v, unique_max=False):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, v)).astype(np.float32)
    if unique_max:
        # a >= 1.0 gap to the runner-up, so temperature -> 0+ must land
        # on the argmax with probability indistinguishable from 1
        peak = rng.integers(0, v, size=b)
        logits[np.arange(b), peak] = logits.max(axis=1) + 1.0
    return torch.from_numpy(logits)


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed % 9973)
    return g


@pytest.mark.parametrize("seed,temp,b,v", CASES, ids=IDS)
def test_same_generator_same_temperature_is_deterministic(seed, temp, b, v):
    logits = _logits(seed, b, v)
    g1, g2 = _gen(seed), _gen(seed)
    t1, t2 = sample_token(logits, g1, temp), sample_token(logits, g2, temp)
    assert torch.equal(t1, t2)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("seed,temp,b,v", CASES, ids=IDS)
def test_temperature_to_zero_limit_is_greedy(seed, temp, b, v):
    """temperature -> 0+ agrees with the greedy (temperature == 0) argmax,
    and greedy leaves the generator's state alone."""
    logits = _logits(seed, b, v, unique_max=True)
    g = _gen(seed)
    before = g.get_state()
    greedy = sample_token(logits, g, 0.0)
    np.testing.assert_array_equal(greedy.numpy(), np.argmax(logits.numpy(), -1))
    assert torch.equal(g.get_state(), before)
    tiny = sample_token(logits, g, 1e-6)
    assert torch.equal(tiny, greedy)


@pytest.mark.parametrize("greedy", [False, True], ids=["sampled", "greedy"])
@pytest.mark.parametrize("seed,temp,b,v", CASES, ids=IDS)
def test_sampled_ids_always_in_vocab(seed, temp, b, v, greedy):
    logits = _logits(seed, b, v)
    t = sample_token(logits, _gen(seed), 0.0 if greedy else 2 * temp).numpy()
    assert t.shape == (b,) and t.dtype == np.int32
    assert ((t >= 0) & (t < v)).all()
