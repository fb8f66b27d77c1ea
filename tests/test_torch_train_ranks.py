"""The train step across gloo ranks on the CPU against the reference's
single-device step: tensor parallelism with data parallelism.

The port of ``tests/test_distributed.py::test_sharded_train_step_
matches_single_device``: that gate jits the reference's step over an
8-device ``("data", "model")`` mesh and holds it to the single-device
step (loss and every parameter after one step within 1e-4).  Here the
port's ranks (``launch/mesh.spawn``, a process a rank, gloo) run
``make_train_step(mesh=)`` on the gate's batch (``Pipeline(DataConfig(
seed=5), cfg, 8, 32)``, granite-moe-3b-a800m reduced, f32, at data 4 x
model 2: 2 rows a rank, 4 microbatches of 2 global rows) and every
lane is held to the reference's single-device jitted step on the same
weights: the loss and each parameter after the step within the gate's
1e-4, and each gradient within 1e-4 of its leaf's largest magnitude
(the gradients whole, gathered over the mesh).  The same at data 2 x
model 2 on the dense GQA (phi3), MLA (minicpm3), MQA (granite-34b) and
tied-embedding (gemma) lanes, on hymba-1.5b, rwkv6-7b and whisper-tiny
(every group split: the leaves a rank holds whole but slices to its
heads get their gradient all-reduced over ``"model"``), and on hymba at
data 1 x model 4, where only its MLP and vocabulary split.  In bf16
hymba's and rwkv6's ranks drift from one device's bf16 gradients by the
split sums' rounding: no more than bf16's own rounding moves one
device's gradients from f32.  The lanes' rank code is in
``tests/train_lanes.py``, the reference's side in ``tests/train_ref.py``.
"""
import numpy as np
import pytest

import train_lanes as TL
import train_ref

BY_WORLD = {8: ["moe"], 4: ["gqa", "mla", "mqa", "tied", "hymba-tp", "rwkv6-tp",
                            "whisper-tp", "hymba-mlp"]}
LANES = [lane for lanes in BY_WORLD.values() for lane in lanes]
# the leaves each rank all-reduces the gradient of over "model", a layer
# (the reduced configs have 2): rwkv6's per-head leaves, hymba's per-head
# leaves and its in_proj (the B and C columns), none where the heads do
# not split (hymba at 4) and none in whisper
PARTIAL = {"hymba-tp": ["A_log", "D", "attn_norm/scale", "dt_bias", "in_proj/w",
                        "ssm_norm/scale"],
           "rwkv6-tp": ["ln_x/bias", "ln_x/scale", "u", "w0", "wl_b"],
           "whisper-tp": [], "hymba-mlp": []}


@pytest.fixture(scope="module")
def runs():
    return train_ref.run_lanes(BY_WORLD)


@pytest.mark.parametrize("lane", LANES)
def test_step_across_ranks_matches_reference(runs, lane):
    train_ref.check_step(runs["got"][lane], runs["ref"][lane])


@pytest.mark.parametrize("lane", LANES)
def test_gradients_across_ranks_match_reference(runs, lane):
    """A replicated leaf summed over "model" by mistake would be ``mp``
    times too large, and one left partial (the MoE router, rwkv6's and
    hymba's per-head leaves, hymba's ``B`` and ``C`` columns) would miss
    the other ranks' heads or experts."""
    train_ref.check_grads(runs["got"][lane]["grads"], runs["ref"][lane]["grads"])


@pytest.mark.parametrize("lane", sorted(PARTIAL))
def test_partial_gradients_are_all_reduced_once(runs, lane):
    """Every rank all-reduces the gradient of exactly the partial leaves,
    once a step each (hymba's ``in_proj``: its whole segments only,
    ``B`` and ``C``: ``2 ssm_state`` columns)."""
    want = sorted(f"layers/{i}/{leaf}" for i in range(2) for leaf in PARTIAL[lane])
    for r in runs["ranks"][lane]:
        assert sorted(r["partial"]) == want
        assert r["grad_wire"][0] == len(want)
    if lane == "hymba-tp":
        # the bytes: A_log, dt_bias and D (4 heads), the two norms (64
        # features each), whole on every rank; in_proj's B and C columns
        # (d_model 64 x 2 x ssm_state 4), not its split xs, gate and dt; f32
        # gradients of 2 layers
        assert runs["ranks"][lane][0]["grad_wire"][1] == 4 * 2 * (3 * 4 + 2 * 64 + 64 * 8)


@pytest.mark.parametrize("lane", TL.DRIFT_LANES)
def test_bf16_gradient_drift_is_rounding(runs, lane):
    """In bf16 the ranks' gradients differ from one device's (the
    row-parallel partials and the gradients entering each split region
    are rounded to bf16 before their f32 sums), and each leaf by no more
    than twice what bf16 itself moves one device's gradient from its f32
    one (a reading of 1.2 at most here): rounding, not a collective, as a
    leaf summed once too often or left partial is off by its own size.
    In f32 the same ranks match the reference within 1e-4 (above), which
    is why the smoke's phase (m) holds these two families in f32."""
    arch = TL.LANES[lane]["arch"]
    got = runs["got"][lane]["bf16_grads"]
    one16 = TL.one_device_grads(runs["params"][arch], arch, "bfloat16")
    one32 = TL.one_device_grads(runs["params"][arch], arch, "float32")
    rounding = []
    for path, w in train_ref.walk(one32):
        scale = max(float(np.linalg.norm(w)), 1e-30)
        drift = float(np.linalg.norm(train_ref.lookup(got, path) - train_ref.lookup(one16, path)))
        own = float(np.linalg.norm(train_ref.lookup(one16, path) - w))
        assert drift <= 2 * own, (path, drift / scale, own / scale)
        rounding.append(own / scale)
    assert max(rounding) > 1e-3          # bf16 rounding there is, and the drift is its size
