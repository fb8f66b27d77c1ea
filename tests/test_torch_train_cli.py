"""The port's train command line on the CPU.

``python -m repro_torch.launch.train --reduced --device cpu`` trains
every architecture of ``configs.ARCH_IDS`` (finite losses and gradient
norms, the final step checkpointed, f32 master weights); a run resumed
from its own checkpoint gives the uninterrupted run's losses and final
state bit for bit; the command line keeps the reference's defaults and
runs on the GPU unless asked for the CPU.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch import tree as TT
from repro_torch.core.types import signed_view
from repro_torch.launch import train


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _argv(arch, ckpt, steps, *extra):
    # the batch: a multiple of every config's grad_accum (at most 8); the
    # sequence: a multiple of the reduced configs' chunks (wkv 8, loss 64)
    return ["--arch", arch, "--reduced", "--device", "cpu", "--steps", str(steps),
            "--batch", "8", "--seq", "32", "--ckpt-dir", str(ckpt), "--log-every", "1",
            *extra]


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_cli_runs_every_arch(arch, tmp_path, capsys):
    res = train.main(_argv(arch, tmp_path, 2, "--posit-moments"))
    assert res.executed == 2 and len(res.losses) == 2
    assert np.isfinite(res.losses).all() and np.isfinite(res.grad_norms).all()
    assert res.ckpt.latest_step() == 2
    params, opt_state = res.state
    assert all(p.dtype == torch.float32 for p in TT.leaves(params))
    assert all(m.dtype == torch.uint16 for m in TT.leaves(opt_state["m"]))
    assert int(opt_state["count"]) == 2
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "done: 2 steps" in out


def test_train_cli_resumes_from_its_own_checkpoint(tmp_path):
    """An uninterrupted 6-step run (checkpoints at 2, 4 and 6; the last
    two kept) against one whose process ended after its step-4
    checkpoint (a copy of it, later ones gone) and then restarted: the
    restarted run resumes at step 4 and its losses and final parameters,
    moments and count equal the uninterrupted run's."""
    full = train.main(_argv("gemma-7b", tmp_path / "a", 6, "--save-every", "2",
                            "--posit-moments"))
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000004", "step_00000006"]
    os.makedirs(tmp_path / "b")
    shutil.copytree(tmp_path / "a" / "step_00000004", tmp_path / "b" / "step_00000004")
    resumed = train.main(_argv("gemma-7b", tmp_path / "b", 6, "--save-every", "2",
                               "--posit-moments"))
    assert resumed.supervisor.events == [("resume", 4)]
    assert resumed.executed == 2
    assert resumed.losses == full.losses[4:]
    for a, b in zip(TT.leaves(full.state), TT.leaves(resumed.state)):
        assert a.dtype == b.dtype and torch.equal(signed_view(a), signed_view(b))
    # a finished run restarted does nothing
    again = train.main(_argv("gemma-7b", tmp_path / "b", 6))
    assert again.executed == 0 and again.losses == []


def test_train_cli_defaults():
    args = train.build_parser().parse_args([])
    assert (args.arch, args.steps, args.batch, args.seq, args.lr, args.save_every,
            args.data, args.log_every, args.posit_moments) == \
        ("gemma-7b", 100, 8, 128, 3e-4, 50, "synthetic", 10, False)
    assert args.device == "cuda" and args.n_layers == 0


def test_train_cli_n_layers_cuts_depth_only():
    args = train.build_parser().parse_args(["--arch", "dbrx-132b", "--n-layers", "3"])
    cfg = train.model_config(args)
    full = configs.get_config("dbrx-132b")
    assert cfg.n_layers == 3 and cfg.d_model == full.d_model and cfg.vocab == full.vocab
    assert not cfg.fsdp and not cfg.seq_shard_activations


def test_train_cli_raises_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour of a host without a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path)])
