"""The collectives of tensor-parallel serving.

The reference places its weights by the rule table and lets GSPMD insert
the collectives; the port runs each rank's shard eagerly and makes them
explicit, over the ``"model"`` process group of the mesh
(``torch.distributed``):

* an all-reduce after each row-parallel product: attention ``wo``, the
  MLP's ``wo``, and the MoE's combine of this rank's experts (rwkv6's
  ``wo`` and ``cm_wv``, hymba's ``wo``, whisper's ``wo``s, whose bias is
  added once, after it);
* the f32 sums of a norm over features split across the ranks
  (rwkv6's ``ln_x``, hymba's ``attn_norm`` and ``ssm_norm``);
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

Training runs the same forward under autograd, so each collective is a
``torch.autograd.Function`` with the backward its forward needs:

* :meth:`TensorParallel.reduce`, the row-parallel sum: all-reduce
  forward, identity backward (the residual it feeds is replicated, so
  every rank already holds the whole gradient; an all-reduce there, as
  ``torch.distributed.nn.functional.all_reduce`` makes, would multiply
  it by the group's size);
* :meth:`TensorParallel.enter`, its partner at the input of each
  column-parallel product: identity forward, all-reduce backward (each
  rank's products see only its heads, columns or experts, so each holds
  a part of the input's gradient);
* the vocabulary-parallel embedding (a masked lookup, then ``reduce``)
  and the vocabulary gather, whose backward is this rank's slice;
* :meth:`TensorParallel.max`, with no gradient (the vocabulary-parallel
  loss's stabilising maximum);
* :meth:`TensorParallel.feature_sum`, the f32 sums of a norm over split
  features (rwkv6's ``ln_x`` over its heads' outputs, hymba's
  ``attn_norm`` and ``ssm_norm``): all-reduce forward and backward,
  since its result feeds each rank's own features, so each rank holds a
  part of its gradient (unlike ``reduce``'s replicated residual).

Under the sequence layout (``TensorParallel.seq``: the training forward
of the transformer family and hymba where the config sets
``seq_shard_activations``, the reference's Megatron-SP residual and
context-parallel attention) a rank holds its contiguous ``S/size``
positions of dim 1 (B, S, ...), and four more move them:

* :meth:`TensorParallel.seq_gather`, the input of a region that splits
  over ``"model"`` (or that every rank runs whole but whose gradient
  each holds a part of): the whole sequence from each rank's slice, an
  all-reduce into zeros; backward, a reduce-scatter (an all-reduce,
  then this rank's slice);
* :meth:`TensorParallel.seq_scatter`, in place of ``reduce`` after a
  row-parallel product: a reduce-scatter; backward, a gather;
* :meth:`TensorParallel.seq_gather_replicated`, the input of a
  computation every rank runs whole and identically, with its whole
  gradient (hymba's merge): a gather; backward, this rank's slice of
  the gradient, not a sum (a sum would multiply it by the group's
  size, ``reduce``'s trap);
* :meth:`TensorParallel.seq_slice`, this rank's positions of a tensor
  whose gradient is a part on each rank (the output of a region entered
  by ``seq_gather``): a slice, whose gradient autograd places into
  zeros.  It moves nothing, so ``wire`` does not list it.

A gather and a reduce-scatter are full-size all-reduces here (gloo
carries CUDA tensors for ``all_reduce`` and ``broadcast`` alone), so the
layout moves more bytes than the head layout, not fewer.

Context-parallel prefill (``TensorParallel.cp``, serving): each rank
attends its share of a prompt's or chunk's query rows
(:meth:`TensorParallel.cp_rows`) and :meth:`TensorParallel.cp_gather`
gathers the rows' outputs, the same all-reduce into zeros, once a layer.

FSDP (``cfg.fsdp`` in the train step, :class:`DataShards`): a leaf that
``"data"`` splits is gathered whole before its layer uses it (a
broadcast of each rank's piece over ``"data"``, again in a
rematerialised layer's recompute), and its gradient is reduce-scattered
in the backward pass (an all-reduce and this rank's piece), in place of
the data-parallel all-reduce of that leaf's gradient.

Under ``torch.no_grad`` each is its forward alone, the serving path's
collectives.  Beside the ``"model"`` group, :func:`all_reduce_axis`
sums over any mesh axis (the data-parallel gradients, in f32),
:func:`gather_axis` stacks one tensor from each rank of an axis bit for
bit (the pod wire's patterns, a checkpoint's whole leaves) by a
broadcast from each rank in turn of the tensor's bytes (gloo carries
CUDA tensors only for ``all_reduce`` and ``broadcast``, and not every
backend takes 16-bit integers).  Every collective made here is counted
in :data:`wire` (calls and bytes by axis, kind and dtype) so that tests
and the smoke can check what crossed which axis.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map

# the collectives this module made since the last ``wire.clear()``:
# (axis, op, what, dtype) -> [calls, bytes], bytes a rank's payload
wire: dict = {}


def _record(axis: str, op: str, what: str, t: torch.Tensor):
    key = (axis, op, what, str(t.dtype).replace("torch.", ""))
    entry = wire.setdefault(key, [0, 0])
    entry[0] += 1
    entry[1] += t.numel() * t.element_size()


class _Reduce(torch.autograd.Function):
    """All-reduce forward, identity backward."""

    @staticmethod
    def forward(ctx, x, tp, what):
        return tp.all_reduce(x, what=what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Enter(torch.autograd.Function):
    """Identity forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g, what="backward"), None


class _FeatureSum(torch.autograd.Function):
    """All-reduce forward, all-reduce backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_reduce(x, what="norm")

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g, what="backward"), None


class _GatherVocab(torch.autograd.Function):
    """This rank's logit columns -> the full f32 logits; backward: this
    rank's columns of the gradient."""

    @staticmethod
    def forward(ctx, y, tp):
        ctx.tp, ctx.dtype = tp, y.dtype
        v0, n = tp._vocab_slice()
        full = y.new_zeros(tuple(y.shape[:-1]) + (tp.vocab_size,), dtype=torch.float32)
        full[..., v0:v0 + n] = y.to(torch.float32)
        dist.all_reduce(full, group=tp.group)
        _record("model", "all_reduce", "logits", full)
        return full

    @staticmethod
    def backward(ctx, g):
        v0, n = ctx.tp._vocab_slice()
        return g[..., v0:v0 + n].to(ctx.dtype), None


class _SeqGather(torch.autograd.Function):
    """This rank's positions -> the whole sequence; backward: the sum over
    the group, this rank's positions (``replicated``: this rank's
    positions of the gradient alone)."""

    @staticmethod
    def forward(ctx, x, tp, replicated):
        ctx.tp, ctx.replicated = tp, replicated
        return tp._gather_seq(x, "seq_gather_replicated" if replicated else "seq_gather")

    @staticmethod
    def backward(ctx, g):
        if not ctx.replicated:
            g = ctx.tp.all_reduce(g, what="backward")
        return ctx.tp._own_positions(g).contiguous(), None, None


class _SeqScatter(torch.autograd.Function):
    """The sum over the group, this rank's positions; backward: the
    gradient of the whole sequence, gathered."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp._own_positions(tp.all_reduce(x, what="seq_scatter")).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.tp._gather_seq(g, "backward"), None


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank's tensor-parallel plan: the ``"model"`` group, this
    rank's index in it and its size, and which groups of leaves split
    (``sharding.tensor_parallel`` decides)."""
    group: object
    rank: int
    size: int
    attn: bool          # query heads (and ``wo``'s input) split; rwkv6's time-mix
                        # heads, hymba's attention and SSM heads together
    kv: bool            # K/V heads split: the KV caches are head-sharded
    mlp: bool           # the dense MLP's ``d_ff`` splits (rwkv6's channel mix)
    moe: bool           # experts split
    vocab: bool         # the embedding's rows and the head's columns split
    vocab_size: int
    n_experts: int = 0
    seq: bool = False   # the sequence layout: a rank's residual is its positions
                        # (training only; ``sharding.tensor_parallel(seq=)``)
    cp: bool = False    # context-parallel prefill: a rank's query rows of a
                        # prompt or chunk (serving only; ``tensor_parallel(serve=)``)

    def all_reduce(self, x: torch.Tensor, what: str = "activation") -> torch.Tensor:
        """The sum of ``x`` over the group, in f32, back in ``x``'s dtype
        (an f32 ``x`` is summed in place).  No gradient: see
        :meth:`reduce`."""
        y = x.to(torch.float32).contiguous()
        dist.all_reduce(y, group=self.group)
        _record("model", "all_reduce", what, y)
        return y.to(x.dtype)

    def reduce(self, x: torch.Tensor, what: str = "activation") -> torch.Tensor:
        """:meth:`all_reduce` with an identity backward: the sum after a
        row-parallel product."""
        return _Reduce.apply(x, self, what)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` itself, whose gradient is all-reduced over the group in
        the backward pass: the input of a column-parallel product."""
        return _Enter.apply(x, self) if torch.is_grad_enabled() and x.requires_grad else x

    def feature_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, this rank's f32 partial sums over its share of a norm's
        features, summed over the group; the gradient is all-reduced too
        (the sum feeds every rank's own features)."""
        return _FeatureSum.apply(x, self)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``x`` over the group (no gradient)."""
        y = x.detach().to(torch.float32).contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        _record("model", "all_reduce", "loss", y)
        return y

    def _vocab_slice(self):
        n = self.vocab_size // self.size
        return self.rank * n, n

    def positions(self, s: int):
        """``(first, count)`` of this rank's positions of a sequence of
        ``s`` (the sequence layout)."""
        if s % self.size:
            raise ValueError(f"the sequence layout needs 'model' {self.size} to divide "
                             f"the sequence length {s}")
        n = s // self.size
        return self.rank * n, n

    def _own_positions(self, x: torch.Tensor) -> torch.Tensor:
        p0, n = self.positions(x.shape[1])
        return x.narrow(1, p0, n)

    def _gather_seq(self, x: torch.Tensor, what: str) -> torch.Tensor:
        """Every rank's (B, n, ...) positions -> the whole (B, n size, ...)
        sequence in ``x``'s dtype: an f32 all-reduce into zeros (exact:
        one rank holds each position)."""
        n = x.shape[1]
        full = x.new_zeros((x.shape[0], n * self.size) + tuple(x.shape[2:]),
                           dtype=torch.float32)
        full.narrow(1, self.rank * n, n).copy_(x)
        dist.all_reduce(full, group=self.group)
        _record("model", "all_reduce", what, full)
        return full.to(x.dtype)

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions (B, S/size, ...) -> the whole sequence, as
        the input of a region whose gradient each rank holds a part of
        (its heads, columns or experts, or its queries): the gradient is
        summed over the group, this rank's positions kept."""
        return _SeqGather.apply(x, self, False)

    def seq_gather_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions -> the whole sequence, as the input of a
        computation every rank runs whole and identically: the gradient
        is already whole on each rank, and this rank keeps its
        positions of it."""
        return _SeqGather.apply(x, self, True)

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's partial sum over the whole sequence (a row-parallel
        product) -> the group's sum at this rank's positions; the
        gradient is gathered to the whole sequence."""
        return _SeqScatter.apply(x, self)

    def cp_rows(self, s: int, device):
        """``(rows, n)``: this rank's ``n = ceil(s / size)`` contiguous
        query rows of a prefill of ``s`` (context-parallel prefill), the
        pad rows past the end clamped to row ``s - 1`` (their outputs are
        dropped by :meth:`cp_gather`)."""
        n = -(-s // self.size)
        rows = torch.arange(self.rank * n, (self.rank + 1) * n, device=device)
        return rows.clamp(max=s - 1), n

    def cp_gather(self, y: torch.Tensor, s: int) -> torch.Tensor:
        """Every rank's (B, n, F) rows of :meth:`cp_rows` -> the whole
        (B, s, F), the pad rows dropped: an f32 all-reduce into zeros
        (exact), on ``wire`` as ``cp_prefill``.  No gradient: serving."""
        return self._gather_seq(y, "cp_prefill")[:, :s]

    def seq_slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's positions of a whole-sequence ``x`` (no collective;
        the gradient is the slice's, zero elsewhere)."""
        return self._own_positions(x)

    def _vocab_rows(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """This rank's part of the embedding rows of ``tokens``: its own
        vocabulary rows, zero for the others."""
        v0, n = self._vocab_slice()
        local = tokens - v0
        inside = (local >= 0) & (local < n)
        rows = table[local.clamp(0, n - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device))

    def embed(self, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """Rows of the full embedding for ``tokens``, from this rank's
        ``table`` of vocabulary rows: a masked local lookup, then an
        all-reduce (exact: one rank holds each row)."""
        if not self.vocab:
            return table[tokens]
        return self.reduce(self._vocab_rows(table, tokens))

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """This rank's (..., V/size) logit columns -> the full (..., V)
        f32 logits on every rank (an all-reduce into zeros)."""
        if not self.vocab:
            return logits.to(torch.float32)
        return _GatherVocab.apply(logits, self)

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
        _record("model", "broadcast", "token", y)
        return y


# ---------------------------------------------------------------------------
# Any mesh axis: data-parallel sums and bitwise gathers
# ---------------------------------------------------------------------------

def axis_group(mesh, axis: str):
    """``(group, rank, size)`` of ``mesh``'s ``axis`` for this rank."""
    return mesh.get_group(axis), mesh.get_local_rank(axis), mesh.size(
        mesh.mesh_dim_names.index(axis))


def all_reduce_axis(t: torch.Tensor, mesh, axis: str, what: str = "grad") -> torch.Tensor:
    """``t`` summed in place over ``mesh``'s ``axis`` (an f32 tensor: the
    data-parallel gradients and losses)."""
    if t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"all_reduce_axis sums contiguous f32 tensors, got {t.dtype}")
    group, _, size = axis_group(mesh, axis)
    if size > 1:
        dist.all_reduce(t, group=group)
        _record(axis, "all_reduce", what, t)
    return t


class _FsdpGather(torch.autograd.Function):
    """A leaf's ``"data"`` pieces -> the whole leaf; backward: the whole
    gradient summed over ``"data"`` and this rank's piece of it (a
    reduce-scatter; this rank's piece alone where every rank ran the
    whole batch)."""

    @staticmethod
    def forward(ctx, piece, shards, dim):
        ctx.shards, ctx.dim = shards, dim
        return shards.gather(piece, dim)

    @staticmethod
    def backward(ctx, g):
        sh = ctx.shards
        if sh.rows_split:
            # a copy: the all-reduce is in place, and autograd's buffer is its own
            g = g.to(torch.float32, memory_format=torch.contiguous_format, copy=True)
            dist.all_reduce(g, group=sh.group)
            _record("data", "all_reduce", "fsdp_scatter", g)
        n = g.shape[ctx.dim] // sh.size
        return g.narrow(ctx.dim, sh.rank * n, n).contiguous(), None, None


@dataclasses.dataclass(frozen=True)
class DataShards:
    """FSDP over the mesh's ``"data"`` axis in the train step: each leaf
    that ``"data"`` splits (``dims``, per leaf in walk order: its dim or
    ``None``; ``sharding.fsdp_dims``) is held as this rank's piece,
    gathered whole where it is used (:meth:`whole`, an autograd
    collective whose backward reduce-scatters the gradient).
    ``rows_split``: whether the step's batch rows split over ``"data"``
    (else every rank runs the whole batch, holds the whole gradient and
    keeps its piece of it, with no sum)."""
    group: object
    rank: int
    size: int
    dims: tuple
    rows_split: bool = True

    def gather(self, piece: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's piece along ``dim`` -> the whole leaf, bit for bit:
        a broadcast of each rank's piece in turn (half the bytes of an
        all-reduce into zeros on two ranks), on ``wire`` as
        ``fsdp_gather``."""
        n = piece.shape[dim]
        shape = list(piece.shape)
        shape[dim] = n * self.size
        full = piece.new_empty(shape)
        buf = piece.contiguous()
        for r in range(self.size):
            src = buf if r == self.rank else torch.empty_like(buf)
            dist.broadcast(_bytes_of(src), group_src=r, group=self.group)
            _record("data", "broadcast", "fsdp_gather", src)
            full.narrow(dim, r * n, n).copy_(src)
        return full

    def whole(self, tree, by_id: dict, seen: set = None):
        """``tree`` with each piece that ``by_id`` (``{id(leaf): dim}``)
        names gathered whole, under autograd; other leaves as they are.
        The ids of the gathered pieces are added to ``seen``."""
        def one(t):
            dim = by_id.get(id(t))
            if dim is None:
                return t
            if seen is not None:
                seen.add(id(t))
            return _FsdpGather.apply(t, self, dim)
        return tree_map(one, tree)

    def all_reduce(self, t: torch.Tensor, what: str = "norm") -> torch.Tensor:
        """The f32 sum of ``t`` over ``"data"`` (no gradient)."""
        y = t.to(torch.float32).contiguous()
        dist.all_reduce(y, group=self.group)
        _record("data", "all_reduce", what, y)
        return y


def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's storage as a flat uint8 view."""
    return t.reshape(-1).view(torch.uint8)


def gather_axis(t: torch.Tensor, mesh, axis: str, what: str = "grad") -> torch.Tensor:
    """``(size, *t.shape)``: each rank of ``mesh``'s ``axis`` contributes
    its ``t``, bit for bit, whatever the dtype: a broadcast of its bytes
    from each rank in turn, into the row that rank owns."""
    group, rank, size = axis_group(mesh, axis)
    out = torch.empty((size,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    for r in range(size):
        row = out[r]
        if r == rank:
            row.copy_(t)
        if size > 1:
            dist.broadcast(_bytes_of(row), group_src=r, group=group)
            _record(axis, "broadcast", what, row)
    return out


def gather_dim(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """The whole of a tensor that ``axis`` splits along ``dim`` into
    equal contiguous pieces, bit for bit (:func:`gather_axis`)."""
    stacked = gather_axis(t.contiguous(), mesh, axis, what="checkpoint")
    return torch.cat(list(stacked.unbind(0)), dim=dim)
