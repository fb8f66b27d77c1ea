"""Shape-only stand-ins for every (arch x shape) cell of the dry run.

The port of ``repro/launch/specs.py`` and of the reference dry run's
``_serve_params_shape``.  Where the reference builds
``jax.ShapeDtypeStruct`` trees with ``jax.eval_shape``, the port runs its
own constructors under a ``FakeTensorMode`` (the one in force, or a new
one): the trees hold fake tensors with shapes, dtypes and a device, and
nothing here allocates (the device: :func:`trace_device`).  :func:`input_specs` and
:func:`decode_token_spec` give :class:`TensorSpec` records, which
:func:`materialize` turns into fake tensors.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import get_family
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype (``jax.ShapeDtypeStruct``'s role)."""
    shape: tuple
    dtype: torch.dtype


def fake_mode():
    """The ``FakeTensorMode`` in force, entered again (a no-op), or a new
    one: fake tensors of two modes cannot meet in one op."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    mode = detect_fake_mode()
    return contextlib.nullcontext(mode) if mode is not None else FakeTensorMode()


def trace_device() -> str:
    """The fake tensors' device: ``"cuda"`` where this torch has CUDA (on
    the card's host: the card's own path), else ``"cpu"``.  A torch built
    without CUDA refuses the device guard that some composite ops (a
    non-contiguous ``contiguous``, ``as_tensor`` onto a device) take on a
    CUDA tensor, fake or not.  No op on the dry run's path branches on
    the device type, and the codec's operators take their fake
    implementations on either device, so the counts are the same."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _on(tree, device):
    """Fake tensors of ``tree``'s shapes and dtypes on ``device`` (the
    families draw their weights with a ``torch.Generator`` of the
    device, which needs CUDA itself on ``"cuda"``: they are drawn on the
    CPU and stood in for)."""
    if torch.device(device).type == "cpu":
        return tree
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
                    if isinstance(t, torch.Tensor) else t, tree)


def materialize(tree, device=None):
    """Fake tensors (uninitialised; shapes alone) for a tree of
    :class:`TensorSpec` under the mode in force."""
    device = device or trace_device()
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device=device), tree)


def input_specs(cfg: ModelConfig, spec: ShapeSpec) -> dict:
    """The data batch of a train or prefill cell: int32 tokens (B, S),
    whisper's f32 ``frames`` (B, encoder_seq, d_model) and a visual
    prefix (B, n_visual_tokens, d_model) where the config has one."""
    b, s = spec.global_batch, spec.seq_len
    out = {"tokens": TensorSpec((b, s), torch.int32)}
    if cfg.family == "whisper":
        out["frames"] = TensorSpec((b, cfg.encoder_seq, cfg.d_model), torch.float32)
    if cfg.n_visual_tokens:
        out["visual"] = TensorSpec((b, cfg.n_visual_tokens, cfg.d_model), torch.float32)
    return out


def params_shape(cfg: ModelConfig, device=None):
    """The whole parameters as fake tensors: the family's ``init_params``
    in f32 (the master weights, as the reference's init) under the fake
    mode (``sharding.whole_shapes`` draws the same)."""
    with fake_mode():
        return _on(get_family(cfg).init_params(cfg, seed=0, device="cpu",
                                               dtype=torch.float32), device or trace_device())


def cache_shape(cfg: ModelConfig, spec: ShapeSpec, device=None):
    """The family's empty linear cache of ``spec.global_batch`` rows and
    ``spec.seq_len`` positions, as fake tensors (its ``len`` and
    ``max_len`` Python ints)."""
    with fake_mode():
        return get_family(cfg).init_cache(cfg, spec.global_batch, spec.seq_len,
                                          device=device or trace_device())


def decode_token_spec(spec: ShapeSpec) -> TensorSpec:
    return TensorSpec((spec.global_batch,), torch.int32)


def _quantizable(path: str, leaf) -> bool:
    """A leaf the posit-weight serving cells store as patterns: every
    dense ``w``, the embedding and the experts' ``wi``/``wg``/``wo``,
    f32 and at least 2-D (the reference's ``_serve_params_shape``)."""
    named = (path.endswith("/w") or path == "tok_embed" or path.endswith("moe/wi")
             or path.endswith("moe/wg") or path.endswith("moe/wo"))
    return named and leaf.dtype == torch.float32 and leaf.ndim >= 2


def serve_params_shape(cfg: ModelConfig, params):
    """``params`` with each :func:`_quantizable` leaf as an empty tensor of
    the ``cfg.weight_posit`` patterns' dtype (``layers.maybe_dequant``
    decodes them at use); ``params`` itself where the config serves no
    posit weights.  On fake tensors nothing is drawn: the trace counts
    shapes (the embedding's patterns are looked up as rows, as the
    reference's dry run looks them up)."""
    if not cfg.weight_posit:
        return params
    store = L.pcfg(cfg.weight_posit).storage_dtype

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, f"{path}/{k}" if path else k) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, f"{path}/{i}") for i, v in enumerate(t)]
        if _quantizable(path, t):
            return torch.empty(t.shape, dtype=store, device=t.device)
        return t
    with fake_mode():
        return walk(params, "")
