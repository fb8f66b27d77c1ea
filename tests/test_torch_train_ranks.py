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
tied-embedding (gemma) lanes.  The lanes' rank code is in
``tests/train_lanes.py``, the reference's side in ``tests/train_ref.py``.
"""
import pytest

import train_ref

BY_WORLD = {8: ["moe"], 4: ["gqa", "mla", "mqa", "tied"]}
LANES = [lane for lanes in BY_WORLD.values() for lane in lanes]


@pytest.fixture(scope="module")
def runs():
    return train_ref.run_lanes(BY_WORLD)


@pytest.mark.parametrize("lane", LANES)
def test_step_across_ranks_matches_reference(runs, lane):
    train_ref.check_step(runs["got"][lane], runs["ref"][lane])


@pytest.mark.parametrize("lane", LANES)
def test_gradients_across_ranks_match_reference(runs, lane):
    """A replicated leaf summed over "model" by mistake would be ``mp``
    times too large, and one left partial (the MoE router) would miss
    the other ranks' experts."""
    train_ref.check_grads(runs["got"][lane]["grads"], runs["ref"][lane]["grads"])
