"""The dry run's cost model: roofline terms on the H100, the model's
useful FLOPs, and a counter of one traced step.

The port of ``repro/launch/hlo_analysis.py`` (``roofline_terms``,
``model_flops``, ``active_param_count``) and of ``hlo_cost.py``'s and
``hlo_attr.py``'s roles.  The reference reads FLOPs, bytes and
collectives out of a compiled XLA program; the port runs its eager step
once on fake tensors (``launch/dryrun.py``) under :class:`StepCounter`:

* FLOPs: the matmuls' and convolutions' (``torch.utils.flop_counter.
  FlopCounterMode``, 2 a multiply-add), a layer's recompute included;
* bytes: each dispatched op's tensor inputs and outputs once, views,
  metadata and collectives left out -- eager PyTorch's materialisation
  of every intermediate, the counterpart of ``hlo_cost``'s top-level
  bytes (an XLA fusion keeps its intermediates on chip; eager ops do not);
* launches of each kernel: the calls of the ``repro_torch`` operators
  (the codec's quantize, dequantize and fused write: a call launches its
  kernel once on the card);
* collective bytes by axis, op and purpose (``collectives.wire``), a
  rank's payload;
* the peak of the storages made in the step and alive at once (each
  op output's storage, followed until it is freed), the counterpart of
  the caching allocator's ``max_memory_allocated`` above the step's
  arguments, without its 512-byte rounding and its cuBLAS workspaces.

All counts are a rank's.  Counted from shapes, never measured.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# H100 SXM5 80 GB, the published data sheet (dense, no sparsity)
PEAK_FLOPS = 989.4e12        # bf16 tensor-core FLOP/s a card
HBM_BW = 3.35e12             # bytes/s of device memory a card
HBM_BYTES = 80e9             # device memory a card
# NVLink 4, 900 GB/s a card both ways: 450 GB/s a direction.  Across the
# nodes of a 256- or 512-card mesh the links are InfiniBand (some 50 GB/s
# a card), so this term is an optimistic bound there
LINK_BW = 450e9


def roofline_terms(*, flops_per_chip: float, bytes_per_chip: float,
                   coll_bytes_per_chip: float, n_chips: int) -> dict:
    """The three roofline terms in seconds on the card (the reference's
    formulas with the H100's rates) and the dominant one."""
    compute_s = flops_per_chip / PEAK_FLOPS
    memory_s = bytes_per_chip / HBM_BW
    collective_s = coll_bytes_per_chip / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant.replace("_s", ""),
            "total_flops": flops_per_chip * n_chips,
            "total_bytes": bytes_per_chip * n_chips}


def model_flops(cfg, spec) -> float:
    """MODEL_FLOPS = 6 N D for a train step (N the active parameters,
    D the tokens), 2 N D for a prefill and 2 N B for a decode step: the
    useful work against the counted FLOPs."""
    n_params = active_param_count(cfg)
    if spec.kind == "train":
        return 6.0 * n_params * spec.global_batch * spec.seq_len
    if spec.kind == "prefill":
        return 2.0 * n_params * spec.global_batch * spec.seq_len
    return 2.0 * n_params * spec.global_batch


def active_param_count(cfg) -> float:
    """Per-token active parameters (a MoE counts its top-k experts)."""
    d, v, l_n = cfg.d_model, cfg.vocab, cfg.n_layers
    if cfg.family == "rwkv6":
        d_att = cfg.n_heads * cfg.head_dim
        per_layer = 4 * d * d_att + d_att * d + 2 * d * cfg.d_ff + d * d
        return v * d * 2 + l_n * per_layer
    if cfg.family == "whisper":
        att = 4 * d * cfg.n_heads * cfg.head_dim
        per_dec = 2 * att + 2 * d * cfg.d_ff
        per_enc = att + 2 * d * cfg.d_ff
        return v * d + cfg.n_layers * per_dec + \
            (cfg.encoder_layers or cfg.n_layers) * per_enc
    # transformer / hymba
    if cfg.mla:
        qh = cfg.qk_nope_dim + cfg.qk_rope_dim
        attn = (d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qh +
                d * (cfg.kv_lora_rank + cfg.qk_rope_dim) +
                cfg.kv_lora_rank * cfg.n_heads *
                (cfg.qk_nope_dim + cfg.v_head_dim) +
                cfg.n_heads * cfg.v_head_dim * d)
    else:
        attn = d * cfg.n_heads * cfg.head_dim * 2 + \
            d * cfg.n_kv_heads * cfg.head_dim * 2
    if cfg.is_moe:
        ffn = 3 * d * cfg.d_ff_expert * cfg.top_k + d * cfg.n_experts
    else:
        ffn = 3 * d * cfg.d_ff
    if cfg.family == "hymba":
        hs, p_dim, n = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        ssm = d * (2 * hs * p_dim + 2 * n + hs) + hs * p_dim * d
        per_layer = attn + ffn + ssm
    else:
        per_layer = attn + ffn
    embed = v * d * (1 if cfg.tie_embeddings else 2)
    return embed + l_n * per_layer


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


class StepCounter(TorchDispatchMode):
    """Sums each dispatched op's tensor inputs and outputs once in
    ``bytes``, leaving out views (which move nothing), ops that touch no
    data and the collectives (their bytes are ``collectives.wire``'s);
    counts the ``repro_torch`` operators' calls in ``launches`` (by
    kernel name, ``posit_codec.launches``' keys); follows the storage of
    every op output not among ``outside`` (the step's arguments) from
    its first output to its release, ``live`` bytes at a time and
    ``peak`` at most.  On fake tensors and real ones alike."""

    _FREE = {"aten::detach", "aten::lift_fresh", "aten::alias", "aten::empty",
             "aten::empty_strided", "aten::empty_like", "aten::new_empty",
             "aten::new_empty_strided", "aten::set_", "aten::resize_"}

    def __init__(self, outside=()):
        super().__init__()
        self.bytes = 0
        self.launches = {}
        self.live = self.peak = 0
        self._seen = set(outside)          # storages' keys (``_cdata``)

    def _released(self, key, nbytes):
        self._seen.discard(key)
        self.live -= nbytes

    def _follow(self, out):
        for t in torch.utils._pytree.tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st._cdata in self._seen:
                continue
            self._seen.add(st._cdata)
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._released, st._cdata, st.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name
        if name.startswith("repro_torch::"):
            kernel = name.split("::")[1]
            self.launches[kernel] = self.launches.get(kernel, 0) + 1
        if not (func.is_view or name in self._FREE or name.startswith("c10d::")
                or name.startswith("_c10d_functional::")):
            flat = torch.utils._pytree.tree_leaves((args, kwargs, out))
            self.bytes += sum(_nbytes(x) for x in flat)
        self._follow(out)
        return out


def top_collectives(wire: dict, n: int = 15) -> list:
    """The largest entries of a ``collectives.wire`` counter as
    ``(bytes, calls, "axis/op/what/dtype")``, largest first (the
    reference's ``hlo_attr.top_collectives``)."""
    rows = sorted(((v[1], v[0], "/".join(k)) for k, v in wire.items()), reverse=True)
    return rows[:n]


def collective_bytes(wire: dict) -> dict:
    """A rank's collective bytes by ``"axis/op"`` from a ``wire``
    counter."""
    out: dict = {}
    for (axis, op, _what, _dt), (_calls, nbytes) in wire.items():
        out[f"{axis}/{op}"] = out.get(f"{axis}/{op}", 0) + nbytes
    return out
