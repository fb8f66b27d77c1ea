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
data 1 x model 4, where only its MLP and vocabulary split.  The
sequence layout (``seq_shard_activations`` kept on, the reference's
Megatron-SP residual and context-parallel attention as the port's
explicit collectives) is held to the same single-device step: the
transformer lanes and the MoE gate with every group split, phi3 at
model 4 (context-parallel attention, with and without a window),
internvl2-1b there with its visual prefix and a whole vocabulary, and
hymba at model 4; its collectives are counted against the code.  FSDP
(the configs' ``fsdp`` kept on) at data 2 x model 2 on the dense, MLA,
MoE and rwkv6 lanes, and with the sequence layout on the tied lane, is
held to the same step, its pieces, gathers and reduce-scatters counted
(``train_ref.check_fsdp``), and beside its data-parallel twin on the
same mesh and layout: the loss bit for bit, the step within 1e-6.  In bf16
hymba's and rwkv6's ranks drift from one device's bf16 gradients by the
split sums' rounding: no more than bf16's own rounding moves one
device's gradients from f32.  The lanes' rank code is in
``tests/train_lanes.py``, the reference's side in ``tests/train_ref.py``.
"""
import numpy as np
import pytest
import torch

import train_lanes as TL
import train_ref

SEQ_LANES = ["gqa-sp", "mla-sp", "mqa-sp", "tied-sp", "gqa-cp", "window-cp", "visual-cp",
             "hymba-cp"]
FSDP_LANES = ["gqa-fsdp-tp", "mla-fsdp-tp", "moe-fsdp-tp", "rwkv6-fsdp-tp", "tied-sp-fsdp"]
BY_WORLD = {8: ["moe", "moe-sp"], 4: ["gqa", "mla", "mqa", "tied", "hymba-tp", "rwkv6-tp",
                                      "whisper-tp", "hymba-mlp"] + SEQ_LANES + FSDP_LANES}
LANES = [lane for lanes in BY_WORLD.values() for lane in lanes]
# the leaves each rank all-reduces the gradient of over "model", a layer
# (the reduced configs have 2): rwkv6's per-head leaves, hymba's per-head
# leaves and its in_proj (the B and C columns), none where the heads do
# not split (hymba at 4) and none in whisper.  Under the sequence layout
# every transformer leaf that does not split: the norms, MQA's wk/wv, MLA's
# query and KV latents with their norms, the router, a context-parallel
# attention's every projection; hymba's context-parallel attention branch
_SP_NORMS = ["ln1/scale", "ln2/scale"]
_CP_ATTN = ["attn/wk/w", "attn/wo/w", "attn/wq/w", "attn/wv/w"] + _SP_NORMS
PARTIAL = {"hymba-tp": ["A_log", "D", "attn_norm/scale", "dt_bias", "in_proj/w",
                        "ssm_norm/scale"],
           "rwkv6-tp": ["ln_x/bias", "ln_x/scale", "u", "w0", "wl_b"],
           "whisper-tp": [], "hymba-mlp": [],
           "gqa-sp": _SP_NORMS, "tied-sp": _SP_NORMS,
           "mla-sp": ["attn/kv_norm/scale", "attn/q_norm/scale", "attn/wdkv/w",
                      "attn/wdq/w"] + _SP_NORMS,
           "mqa-sp": ["attn/wk/w", "attn/wv/w"] + _SP_NORMS,
           "moe-sp": _SP_NORMS + ["moe/router/w"],
           "gqa-cp": _CP_ATTN, "window-cp": _CP_ATTN, "visual-cp": _CP_ATTN,
           "hymba-cp": ["attn_norm/scale", "wk/w", "wq/w", "wv/w"],
           "moe-fsdp-tp": ["moe/router/w"],
           "rwkv6-fsdp-tp": ["ln_x/bias", "ln_x/scale", "u", "w0", "wl_b"]}
# the top-level leaves among them: the final norm under the transformer's
# sequence layout, and the tied embedding whose vocabulary stays whole
PARTIAL_TOP = {lane: ["final_norm/scale"] for lane in SEQ_LANES + ["moe-sp"]
               if lane != "hymba-cp"}
PARTIAL_TOP["visual-cp"] = ["final_norm/scale", "tok_embed"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two torch threads in this process (its one-device gradients; the
    ranks it spawns take one each)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


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
    want = sorted([f"layers/{i}/{leaf}" for i in range(2) for leaf in PARTIAL[lane]]
                  + PARTIAL_TOP.get(lane, []))
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


@pytest.mark.parametrize("lane", FSDP_LANES)
def test_fsdp_pieces_and_collectives(runs, lane):
    """FSDP at data 2 x model 2: each rank holds its pieces and makes the
    gathers and reduce-scatters of ``train_ref.check_fsdp``."""
    train_ref.check_fsdp(lane, runs["ranks"][lane])


@pytest.mark.parametrize("lane", FSDP_LANES)
def test_fsdp_step_is_the_data_parallel_step(runs, lane):
    train_ref.check_fsdp_twin(runs["got"][lane])


def seq_wire(lane) -> dict:
    """The sequence layout's collectives on one rank in the gradients'
    call, ``{"model/all_reduce/<what>/float32": [calls, bytes]}``, worked
    out from the code.  A rank runs ``grad_accum / data`` microbatches of
    ``BATCH / grad_accum`` rows (whole microbatches: the data ranks take
    rows in order).  A transformer call: the embedding's reduce-scatter
    and the head's gather where the vocabulary splits; a layer's
    attention gather (context parallel: for the keys and values) and
    reduce-scatter where its heads split; its feed-forward's gather (a
    MoE always, an MLP where ``d_ff`` splits) and reduce-scatter (where
    the experts or ``d_ff`` split).  Each layer is rematerialised, and
    the replay stops at its last saved tensor: it repeats every gather
    and the attention's reduce-scatter, never the feed-forward's.  Each
    forward gather or reduce-scatter has one backward all-reduce.  Every
    one moves an f32 (rows, S, d_model) tensor.  Hymba: one replicated
    gather of the attention branch's (rows, S, heads x head_dim) output a
    layer, again in the replay of each window layer; its backward is a
    slice, while the branch's input enters (one all-reduce a layer)
    beside the MLP's and the head's, as with the head layout."""
    from repro_torch import configs
    from repro_torch.runtime.sharding import _split_groups

    cfg = TL.config_of(configs, lane)
    data, mp = TL.LANES[lane]["mesh"]
    g = _split_groups(cfg, mp)
    n = cfg.n_layers
    calls, rows = cfg.grad_accum // data, TL.BATCH // cfg.grad_accum
    if cfg.family == "hymba":
        width = cfg.n_heads * cfg.head_dim
        per = {"seq_gather_replicated": n + n - len(cfg.global_layers),
               "backward": n + n * g["mlp"] + g["vocab"]}
        widths = {"seq_gather_replicated": width, "backward": cfg.d_model}
    else:
        ff_gather, ff_scatter = cfg.is_moe or g["mlp"], g["moe"] if cfg.is_moe else g["mlp"]
        fwd_gather = g["vocab"] + n * (1 + ff_gather)
        fwd_scatter = g["vocab"] + n * (g["attn"] + ff_scatter)
        per = {"seq_gather": fwd_gather + n * (1 + ff_gather),
               "seq_scatter": fwd_scatter + n * g["attn"],
               "backward": fwd_gather + fwd_scatter}
        widths = dict.fromkeys(per, cfg.d_model)
    return {f"model/all_reduce/{what}/float32": [calls * k, calls * k * rows * TL.SEQ
                                                  * widths[what] * 4]
            for what, k in per.items() if k}


@pytest.mark.parametrize("lane", LANES)
def test_sequence_layout_collectives_are_pinned(runs, lane):
    """Every rank of a lane whose config keeps ``seq_shard_activations``
    makes exactly the sequence collectives worked out from the code
    (``seq_wire``: calls and bytes by ``what``), and no rank of a lane
    whose flag is off makes any (the head layout runs there)."""
    for r in runs["ranks"][lane]:
        seq = {k: v for k, v in r["wire"].items() if "/seq_" in k}
        if not TL.LANES[lane].get("seq"):
            assert not seq, seq
            continue
        want = seq_wire(lane)
        got = {k: v for k, v in r["wire"].items() if k in seq or k in want}
        assert got == want, (got, want)
