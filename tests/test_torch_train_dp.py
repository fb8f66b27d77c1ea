"""Data parallelism across gloo ranks on the CPU for hymba, rwkv6 and
whisper, and the launcher's ranks.

hymba-1.5b, rwkv6-7b and whisper-tiny reduced, f32, at data 2 x model
1 (``make_train_step(mesh=)``, a process a rank, gloo) on the sharded
gate's batch, against the reference's single-device jitted step on the
same weights: the loss and each parameter after one step within 1e-4,
each gradient within 1e-4 of its leaf's largest magnitude (the three at
``"model"`` > 1: ``tests/test_torch_train_ranks.py``).  So too FSDP at
data 2 (the configs' ``fsdp`` kept on) on the dense, MLA, MoE and rwkv6
lanes, with their pieces and collectives counted, each beside its
data-parallel twin on the same mesh.
``launch/train.py --rank-devices cpu,cpu`` gives the single-device
launch's losses within 1e-5, and so does ``cpu,cpu,cpu`` on a batch
that three ranks do not divide (8 x 32, two steps: the launcher's ranks
take a share of the caller's two torch threads).
"""
import pytest
import torch

import train_ref
from repro_torch.launch import train

FSDP_LANES = ["gqa-fsdp", "mla-fsdp", "moe-fsdp", "rwkv6-fsdp"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process (the launcher's ranks take one
    each of them, the tests' own spawns one each)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
BY_WORLD = {2: ["hymba", "rwkv6", "whisper"] + FSDP_LANES}
LANES = BY_WORLD[2]


@pytest.fixture(scope="module")
def runs():
    return train_ref.run_lanes(BY_WORLD)


@pytest.mark.parametrize("lane", LANES)
def test_data_parallel_step_matches_reference(runs, lane):
    train_ref.check_step(runs["got"][lane], runs["ref"][lane])


@pytest.mark.parametrize("lane", LANES)
def test_data_parallel_gradients_match_reference(runs, lane):
    train_ref.check_grads(runs["got"][lane]["grads"], runs["ref"][lane]["grads"])


@pytest.mark.parametrize("lane", FSDP_LANES)
def test_fsdp_pieces_and_collectives(runs, lane):
    """FSDP at data 2: each rank holds its pieces and makes the gathers
    and reduce-scatters of ``train_ref.check_fsdp``."""
    train_ref.check_fsdp(lane, runs["ranks"][lane])


@pytest.mark.parametrize("lane", FSDP_LANES)
def test_fsdp_step_is_the_data_parallel_step(runs, lane):
    train_ref.check_fsdp_twin(runs["got"][lane])


def test_launcher_rank_devices_matches_one_device(tmp_path):
    """Two data-parallel ranks through the command line: rank 0's losses
    and gradient norms are the single device's within 1e-5 (gemma-7b
    reduced, grad_accum 4: each rank runs two of the four microbatches),
    and the ranks save the single device's checkpoints."""
    argv = ["--arch", "gemma-7b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "8", "--seq", "32", "--log-every", "1", "--save-every", "1"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    ranks = train.main(argv + ["--ckpt-dir", str(tmp_path / "ranks"),
                               "--rank-devices", "cpu,cpu"])
    assert ranks.executed == one.executed == 2 and len(ranks.ranks) == 2
    for r in ranks.ranks:
        assert r["losses"] == ranks.ranks[0]["losses"]
    for a, b in zip(ranks.losses, one.losses):
        assert abs(a - b) <= 1e-5 * abs(b), (ranks.losses, one.losses)
    for a, b in zip(ranks.grad_norms, one.grad_norms):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert sorted(p.name for p in (tmp_path / "ranks").iterdir()) == \
        sorted(p.name for p in (tmp_path / "one").iterdir())


def test_launcher_ranks_that_do_not_divide_the_batch_match_one_device(tmp_path):
    """Three data-parallel ranks on a batch of 8: ``"data"`` does not
    divide it, so (as the reference's ``batch_axes`` replicates it)
    every rank runs the whole batch and no gradient is summed over the
    ranks; rank 0's losses and gradient norms are the single device's
    within 1e-5, not three times them."""
    argv = ["--arch", "gemma-7b", "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "8", "--seq", "32", "--log-every", "1", "--save-every", "100"]
    one = train.main(argv + ["--ckpt-dir", str(tmp_path / "one")])
    ranks = train.main(argv + ["--ckpt-dir", str(tmp_path / "ranks"),
                               "--rank-devices", "cpu,cpu,cpu"])
    assert ranks.executed == one.executed == 2 and len(ranks.ranks) == 3
    for r in ranks.ranks:
        assert r["losses"] == ranks.ranks[0]["losses"]
    for a, b in zip(ranks.losses, one.losses):
        assert abs(a - b) <= 1e-5 * abs(b), (ranks.losses, one.losses)
    for a, b in zip(ranks.grad_norms, one.grad_norms):
        assert abs(a - b) <= 1e-5 * abs(b), (ranks.grad_norms, one.grad_norms)
