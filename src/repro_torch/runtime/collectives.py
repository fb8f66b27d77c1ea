"""The collectives of tensor-parallel serving.

The reference places its weights by the rule table and lets GSPMD insert
the collectives; the port runs each rank's shard eagerly and makes them
explicit, over the ``"model"`` process group of the mesh
(``torch.distributed``):

* an all-reduce after each row-parallel product: attention ``wo``, the
  MLP's ``wo``, and the MoE's combine of this rank's experts;
* the vocabulary-parallel embedding: a masked local lookup, then an
  all-reduce (each token's row is non-zero on one rank only, so the sum
  is exact);
* the vocabulary-sharded logits gathered to full width;
* the sampled token broadcast from rank 0 when sampling draws random
  numbers (greedy tokens are the argmax of logits identical on every
  rank).

Only ``all_reduce`` and ``broadcast`` are used, so every collective runs
on gloo too, which carries CUDA tensors for those two alone: that is
the transport when ranks share a card (NCCL refuses two ranks on one
device).  The logits gather is an all-reduce into a zeroed full-width
buffer; sums run in f32.  A group that does not split (``attn``,
``mlp``, ``moe``, ``vocab`` false) keeps its leaves whole on every rank
and its collective is skipped.  Without a plan (``tp is None``) no
function here is called: the single-device path is unchanged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's tensor-parallel plan: the ``"model"`` group, this
    rank's index in it and its size, and which groups of leaves split
    (``sharding.tensor_parallel`` decides)."""
    group: object
    rank: int
    size: int
    attn: bool          # query heads (and ``wo``'s input) split
    kv: bool            # K/V heads split: the arena is head-sharded
    mlp: bool           # the dense MLP's ``d_ff`` splits
    moe: bool           # experts split
    vocab: bool         # the embedding's rows and the head's columns split
    vocab_size: int
    n_experts: int = 0

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group, in f32, back in ``x``'s dtype
        (an f32 ``x`` is summed in place)."""
        y = x.to(torch.float32).contiguous()
        dist.all_reduce(y, group=self.group)
        return y.to(x.dtype)

    def _vocab_slice(self):
        n = self.vocab_size // self.size
        return self.rank * n, n

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the full embedding for ``tokens``, from this rank's
        ``table`` of vocabulary rows: a masked local lookup, then an
        all-reduce (exact: one rank holds each row)."""
        if not self.vocab:
            return table[tokens]
        v0, n = self._vocab_slice()
        local = tokens - v0
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))
        return self.all_reduce(rows)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's (..., V/size) logit columns -> the full (..., V)
        f32 logits on every rank (an all-reduce into zeros)."""
        if not self.vocab:
            return logits.to(torch.float32)
        v0, n = self._vocab_slice()
        full = logits.new_zeros(tuple(logits.shape[:-1]) + (self.vocab_size,),
                                dtype=torch.float32)
        full[..., v0:v0 + n] = logits.to(torch.float32)
        dist.all_reduce(full, group=self.group)
        return full

    def expert_slice(self):
        """``(first, count)`` of this rank's experts, or ``None`` when the
        experts do not split."""
        if not self.moe:
            return None
        n = self.n_experts // self.size
        return self.rank * n, n

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as rank 0 of the group holds it, on every rank."""
        y = t.contiguous()
        dist.broadcast(y, group_src=0, group=self.group)
        return y
