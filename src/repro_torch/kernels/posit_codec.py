"""Posit codec kernels: f32 -> posit patterns and back (CUDA).

Replaces ``repro/kernels/posit_codec.py`` ``quantize_2d`` /
``dequantize_2d`` (the Pallas TPU kernels ``_quant_kernel`` and
``_dequant_kernel``).  The kernels (``csrc/posit_codec.cu``) are
elementwise, so these wrappers take a contiguous tensor of any shape.

Bound on the H100: memory -- posit16 moves 6 B per element (4 B f32 in,
2 B pattern out, or the reverse; posit32 8 B, posit8 5 B).  Both run
vector passes on a persistent grid, 16-byte vectors on the f32 side, and
cover the five configs of ``core/types.py``.  The quantize's encode is a table entry per sign and
exponent in shared memory and one 32-bit rounding
(``csrc/posit_quant.cuh``).  The dequantize takes up to four leaves a
launch (:func:`dequantize_many`: a layer's K and V, or MLA's latent and
RoPE key) and can round each value through bf16 on its way to f32, the
values the linear decode's einsums read.

On the serving path the quantize is fused into the paged KV write
(:func:`paged_write`, ``csrc/posit_paged_write.cu``, the same encode):
one launch quantizes a token's (or a prefill chunk's) KV rows and stores
the patterns straight into their arena slots, dropping masked and
sentinel writes on the device.  The dequantize is fused into the
chunked-prefill arena read (:func:`paged_read`,
``csrc/posit_paged_read.cu``): one launch gathers a layer's two leaves
through the chunk's virtual table, decodes them and zeroes the slots
that are not resident.

On a CPU tensor the wrappers run the plain versions (``core.convert``);
on a CUDA tensor they launch the kernel or raise.

The quantize, the job-form dequantize and the fused write go through
``torch.library`` operators (``repro_torch::posit_quantize``,
``repro_torch::posit_dequantize``, ``repro_torch::posit_paged_write``,
the last declaring its in-place arena writes), each with three
implementations: the kernel on the card, the plain version on the CPU,
and a fake one that gives the outputs' shapes and dtypes, so that a step
can be traced on fake tensors (``launch/dryrun.py``, which counts
the operators' calls: a call is a launch on the card).  Only the card's
implementations add to :data:`launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.convert import f32_to_posit, posit_to_f32
from repro_torch.core.types import CONFIGS, PositConfig, signed_view

from . import _build

launches = {"posit_quantize": 0, "posit_dequantize": 0,
            "posit_paged_write": 0, "posit_paged_read": 0}
_BY_BITS = {(c.nbits, c.es): c for c in CONFIGS}


def quantize_plain(x: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Plain PyTorch version of the quantize kernel."""
    return f32_to_posit(x, cfg)


def dequantize_plain(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Plain PyTorch version of the dequantize kernel."""
    return posit_to_f32(p, cfg)


def dequantize_many_plain(leaves, cfg: PositConfig, round_to=None):
    """Plain PyTorch version of :func:`dequantize_many`: each leaf
    decoded to f32 and, with ``round_to=torch.bfloat16``, cast to bf16
    and back to f32.  NaR keeps the codec's NaN 0x7FC00000 through the
    cast, as the reference's ``astype(bfloat16)`` does (torch's own cast
    of a NaN gives other bits on other devices and versions)."""
    _check_round_to(round_to)
    outs = []
    for p in leaves:
        y = dequantize_plain(p, cfg)
        if round_to is not None:
            y = torch.where(torch.isnan(y), y, y.to(round_to).to(torch.float32))
        outs.append(y)
    return outs


_MAX_DEQ_JOBS = 4


def _check_round_to(round_to):
    if round_to not in (None, torch.bfloat16):
        raise ValueError(f"dequantize: round_to is None or torch.bfloat16, "
                         f"got {round_to}")


def _quantize_call(x: torch.Tensor, cfg: PositConfig):
    """Checks, the output and the C call of one quantize of a CUDA
    tensor: ``(call, out)``."""
    _build.check_cfg(cfg, "quantize")
    if x.device.type != "cuda" or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"quantize needs a contiguous float32 CUDA tensor, got "
                         f"{x.dtype} on {x.device} (contiguous={x.is_contiguous()})")
    out = torch.empty(x.shape, dtype=cfg.storage_dtype, device=x.device)
    lib = _build.load("posit_codec")
    args = (cfg.nbits, cfg.es, x.data_ptr(), out.data_ptr(), x.numel(),
            _build.sm_count(x.device), torch.cuda.current_stream(x.device).cuda_stream)
    return (lambda: lib.posit_quantize(*args)), out


def _dequantize_call(leaves, cfg: PositConfig, round_to):
    """Checks, the outputs and the C call of one dequantize launch over
    ``leaves`` (CUDA tensors): ``(call, outs)``."""
    _build.check_cfg(cfg, "dequantize")
    _check_round_to(round_to)
    if not 0 < len(leaves) <= _MAX_DEQ_JOBS:
        raise ValueError(f"dequantize: 1 to {_MAX_DEQ_JOBS} leaves a launch, got "
                         f"{len(leaves)}")
    dev = leaves[0].device
    for p in leaves:
        if p.device.type != "cuda" or p.device != dev or p.dtype != cfg.storage_dtype \
                or not p.is_contiguous():
            raise ValueError(f"dequantize needs contiguous {cfg.storage_dtype} leaves "
                             f"on one CUDA device, got {p.dtype} on {p.device} "
                             f"(contiguous={p.is_contiguous()})")
    outs = [torch.empty(p.shape, dtype=torch.float32, device=dev) for p in leaves]
    lib = _build.load("posit_codec")
    n = len(leaves)
    args = (cfg.nbits, cfg.es, int(round_to is not None), n,
            (ctypes.c_void_p * n)(*[p.data_ptr() for p in leaves]),
            (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
            (ctypes.c_longlong * n)(*[p.numel() for p in leaves]),
            _build.sm_count(dev), torch.cuda.current_stream(dev).cuda_stream)
    return (lambda: lib.posit_dequantize(*args)), outs


@torch.library.custom_op("repro_torch::posit_quantize", mutates_args=(), device_types="cpu")
def _quantize_op(x: torch.Tensor, nbits: int, es: int) -> torch.Tensor:
    return quantize_plain(x, _BY_BITS[nbits, es])


@_quantize_op.register_kernel("cuda")
def _quantize_cuda(x, nbits, es):
    call, out = _quantize_call(x, _BY_BITS[nbits, es])
    _build.check(call(), "posit_quantize")
    launches["posit_quantize"] += 1
    return out


@_quantize_op.register_fake
def _quantize_fake(x, nbits, es):
    return x.new_empty(x.shape, dtype=_BY_BITS[nbits, es].storage_dtype)


def quantize(x: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """f32 tensor -> posit patterns (``cfg.storage_dtype``), same shape."""
    return _quantize_op(x, cfg.nbits, cfg.es)


@torch.library.custom_op("repro_torch::posit_dequantize", mutates_args=(),
                         device_types="cpu")
def _dequantize_op(leaves: list[torch.Tensor], nbits: int, es: int,
                   round_bf16: bool) -> list[torch.Tensor]:
    return dequantize_many_plain(leaves, _BY_BITS[nbits, es],
                                 torch.bfloat16 if round_bf16 else None)


@_dequantize_op.register_kernel("cuda")
def _dequantize_cuda(leaves, nbits, es, round_bf16):
    call, outs = _dequantize_call(leaves, _BY_BITS[nbits, es],
                                  torch.bfloat16 if round_bf16 else None)
    _build.check(call(), "posit_dequantize")
    launches["posit_dequantize"] += 1
    return outs


@_dequantize_op.register_fake
def _dequantize_fake(leaves, nbits, es, round_bf16):
    return [p.new_empty(p.shape, dtype=torch.float32) for p in leaves]


def dequantize_many(leaves, cfg: PositConfig, round_to=None):
    """Posit-pattern leaves (``cfg.storage_dtype``, any shapes) -> one
    f32 tensor each, of the same shape; with ``round_to=torch.bfloat16``
    every value is rounded to nearest-even bf16 on its way
    (:func:`dequantize_many_plain`).

    On CUDA tensors: one launch of ``csrc/posit_codec.cu``'s dequantize
    for all leaves (1 to 4, contiguous, on one device).  The first
    leaf's device chooses the path."""
    _check_round_to(round_to)
    return _dequantize_op(list(leaves), cfg.nbits, cfg.es, round_to is not None)


def dequantize(p: torch.Tensor, cfg: PositConfig) -> torch.Tensor:
    """Posit patterns (``cfg.storage_dtype``) -> f32 tensor, same shape:
    :func:`dequantize_many` of one leaf."""
    return dequantize_many([p], cfg)[0]


def quantize_call(x: torch.Tensor, cfg: PositConfig):
    """For timing the quantize alone: ``(call, out)``, where ``call()``
    launches the kernel into ``out`` and returns the CUDA error code.
    Not counted in ``launches``; CUDA tensors only."""
    return _quantize_call(x, cfg)


def dequantize_call(p: torch.Tensor, cfg: PositConfig):
    """:func:`quantize_call` for the dequantize of one leaf to f32."""
    call, outs = _dequantize_call([p], cfg, None)
    return call, outs[0]


def dequantize_many_call(leaves, cfg: PositConfig, round_to=None):
    """:func:`quantize_call` for :func:`dequantize_many`: ``(call,
    outs)``."""
    return _dequantize_call(leaves, cfg, round_to)


# ---------------------------------------------------------------------------
# Quantize fused into the paged KV write
# ---------------------------------------------------------------------------

_PAGED_CFGS = ((16, 2), (8, 2))
_FLOAT_KINDS = {torch.float32: 0, torch.bfloat16: 1}
_MAX_JOBS = 128


def scatter_slots(jobs, slots: torch.Tensor, dense: bool = False) -> None:
    """The masked scatter of the paged write, in place: row r of each
    job's ``rows`` goes to flat slot ``slots[r]`` of its ``arena``.

    ``jobs`` is a list of ``(arena, rows)``: ``arena`` one layer's leaf
    (nb, bs, *feat), ``rows`` (R, *feat) of the arena's dtype; every leaf
    has the same nb * bs slots.  ``slots`` (R,) int64 is row r's flat
    slot ``block * bs + offset``; a negative slot (or one past
    ``nb * bs``) drops the row's write (one host sync for all jobs).
    ``dense``: the caller knows every slot is in range (a linear write,
    whose capacity the host has checked), so the mask and its host sync
    are skipped."""
    if not jobs:
        return
    n_slots = jobs[0][0].shape[0] * jobs[0][0].shape[1]
    keep = None if dense else torch.nonzero((slots >= 0) & (slots < n_slots))[:, 0]
    dst = slots if dense else slots[keep]
    for arena, rows in jobs:
        flat = signed_view(arena).view(n_slots, -1)
        src = signed_view(rows).reshape(rows.shape[0], -1)
        flat[dst] = src if dense else src[keep]


def paged_write_plain(jobs, slots: torch.Tensor, cfg: PositConfig) -> None:
    """Plain PyTorch version of the fused write: :func:`quantize_plain`
    of each source, then :func:`scatter_slots` into its arena, in place.

    ``jobs`` is a list of ``(arena, src)``: ``arena`` one layer's leaf
    (nb, bs, *feat) of posit patterns, ``src`` (R, *feat) f32 or bf16.
    ``slots`` as in :func:`scatter_slots`."""
    scatter_slots([(a, quantize_plain(src.to(torch.float32), cfg))
                   for a, src in jobs], slots)


def _check_devices(jobs, slots):
    """The device every arena, source and ``slots`` of a write lie on;
    raises if they differ or if there is no job."""
    if not jobs:
        raise ValueError("paged_write: no jobs")
    dev = jobs[0][0].device
    for t in [slots] + [t for job in jobs for t in job]:
        if t.device != dev:
            raise ValueError(f"paged_write: arenas, sources and slots must "
                             f"share one device, got {t.device} and {dev}")
    return dev


def _paged_write_call(jobs, slots, cfg, floor=False):
    """Checks and the C call of one fused write (returns its CUDA error
    code); with ``floor``, the same call of an empty kernel."""
    if (cfg.nbits, cfg.es) not in _PAGED_CFGS:
        raise ValueError(f"paged_write: the kernel takes posit16 and posit8 "
                         f"(es 2), got {cfg}")
    if not 0 < len(jobs) <= _MAX_JOBS:
        raise ValueError(f"paged_write: 1 to {_MAX_JOBS} jobs a launch, got "
                         f"{len(jobs)}")
    dev = _check_devices(jobs, slots)
    rows = slots.shape[0]
    if slots.dtype != torch.int64 or slots.ndim != 1 \
            or not slots.is_contiguous():
        raise ValueError(f"paged_write: slots must be a contiguous int64 "
                         f"(R,) tensor, got {slots.dtype} "
                         f"{tuple(slots.shape)}")
    n_slots = jobs[0][0].shape[0] * jobs[0][0].shape[1]
    src_kind = _FLOAT_KINDS.get(jobs[0][1].dtype)
    for arena, src in jobs:
        if arena.dtype != cfg.storage_dtype or not arena.is_contiguous() \
                or arena.ndim < 2 \
                or arena.shape[0] * arena.shape[1] != n_slots:
            raise ValueError(f"paged_write: arena must be a contiguous "
                             f"{cfg.storage_dtype} (nb, bs, ...) leaf of "
                             f"{n_slots} slots, got {arena.dtype} "
                             f"{tuple(arena.shape)}")
        if _FLOAT_KINDS.get(src.dtype) != src_kind or src_kind is None \
                or not src.is_contiguous() \
                or tuple(src.shape) != (rows,) + tuple(arena.shape[2:]):
            raise ValueError(f"paged_write: source must be a contiguous f32 "
                             f"or bf16 tensor of shape "
                             f"{(rows,) + tuple(arena.shape[2:])}, every "
                             f"source of one dtype; got {src.dtype} "
                             f"{tuple(src.shape)}")
    fn = getattr(_build.load("posit_paged_write"),
                 "posit_paged_write_floor" if floor else "posit_paged_write")
    n = len(jobs)
    srcs = (ctypes.c_void_p * n)(*[s.data_ptr() for _, s in jobs])
    arenas = (ctypes.c_void_p * n)(*[a.data_ptr() for a, _ in jobs])
    widths = (ctypes.c_int * n)(*[a[0, 0].numel() for a, _ in jobs])
    args = (cfg.nbits, src_kind, n, srcs, arenas, widths, slots.data_ptr(),
            rows, n_slots, torch.cuda.current_stream(dev).cuda_stream)
    return lambda: fn(*args)


def paged_write(jobs, slots: torch.Tensor, cfg: PositConfig) -> None:
    """Quantize KV rows to posit patterns and store them straight into
    their arena slots, in place (:func:`paged_write_plain` for the
    layout of ``jobs`` and ``slots``).  Every job shares ``slots``; a
    decode step passes a layer's two leaves, a prefill chunk one leaf of
    every layer.

    On a CUDA tensor: one launch of ``csrc/posit_paged_write.cu`` (1 to
    128 jobs), posit16 or posit8 (es 2); dropped rows are skipped on the
    device, with no host sync.  The arenas' device chooses the path;
    sources and ``slots`` must lie on it."""
    _check_devices(jobs, slots)
    _paged_write_op([a for a, _ in jobs], [x for _, x in jobs], slots, cfg.nbits, cfg.es)


@torch.library.custom_op("repro_torch::posit_paged_write", mutates_args=("arenas",),
                         device_types="cpu")
def _paged_write_op(arenas: list[torch.Tensor], srcs: list[torch.Tensor],
                    slots: torch.Tensor, nbits: int, es: int) -> None:
    paged_write_plain(list(zip(arenas, srcs)), slots, _BY_BITS[nbits, es])


@_paged_write_op.register_kernel("cuda")
def _paged_write_cuda(arenas, srcs, slots, nbits, es):
    call = _paged_write_call(list(zip(arenas, srcs)), slots, _BY_BITS[nbits, es])
    _build.check(call(), "posit_paged_write")
    launches["posit_paged_write"] += 1


@_paged_write_op.register_fake
def _paged_write_fake(arenas, srcs, slots, nbits, es):
    return None


def paged_write_call(jobs, slots: torch.Tensor, cfg: PositConfig, floor: bool = False):
    """For timing the fused write alone: ``call()`` launches the kernel
    once more on the same jobs and returns the CUDA error code; with
    ``floor``, an empty kernel with the same job table and grid through
    the same C call (the launch floor).  Not counted in ``launches``;
    CUDA tensors only."""
    return _paged_write_call(jobs, slots, cfg, floor)


# ---------------------------------------------------------------------------
# Dequantize fused into the chunked-prefill arena read
# ---------------------------------------------------------------------------

def zero_invalid(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero time-axis slots whose (B, T) mask is False: gathered arena
    garbage (sentinel clamps, older ring blocks, sanitizer poison) stays
    out of the downstream matmuls; valid slots are untouched."""
    m = mask.reshape(tuple(mask.shape) + (1,) * (x.ndim - 2))
    return torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))


def paged_read_plain(arenas, vtables: torch.Tensor, lens: torch.Tensor,
                     low_pos: torch.Tensor, cfg, out_dtype: torch.dtype):
    """Plain PyTorch version of the fused read: for each leaf,
    ``layers.paged_gather`` through ``vtables``, :func:`dequantize_plain`
    (skipped when ``cfg`` is None: the arenas hold f32/bf16 values), the
    cast to ``out_dtype`` and :func:`zero_invalid` of the slots t outside
    ``low_pos[b] <= t < lens[b]``.

    ``arenas`` lists one layer's leaves (nb, bs, *feat); ``vtables``
    (B, Wv) the chunk's virtual block table; ``lens`` and ``low_pos``
    (B,).  Returns one (B, Wv * bs, *feat) tensor per leaf."""
    # layers imports this module, so its gather is imported here
    from repro_torch.models.layers import paged_gather

    t_len = vtables.shape[1] * arenas[0].shape[1]
    apos = torch.arange(t_len, device=vtables.device)[None, :]
    resident = (apos < lens[:, None]) & (apos >= low_pos[:, None])
    outs = []
    for arena in arenas:
        g = paged_gather(arena, vtables)
        if cfg is not None:
            g = dequantize_plain(g, cfg)
        outs.append(zero_invalid(g.to(out_dtype), resident))
    return outs


def paged_read_call(arenas, vtables, lens, low_pos, cfg, out_dtype):
    """Checks, outputs and the C call of one fused read: returns
    ``(call, outs)``, where ``call()`` launches the kernel into ``outs``
    and returns the CUDA error code (not counted in ``launches``; for
    timing the kernel alone).  CUDA tensors only."""
    if (cfg.nbits, cfg.es) not in _PAGED_CFGS:
        raise ValueError(f"paged_read: the kernel takes posit16 and posit8 "
                         f"(es 2), got {cfg}")
    if out_dtype not in _FLOAT_KINDS or not 1 <= len(arenas) <= 2:
        raise ValueError(f"paged_read: one or two leaves to f32 or bf16, got "
                         f"{len(arenas)} to {out_dtype}")
    dev = arenas[0].device
    b, vw = vtables.shape
    nb, bs = arenas[0].shape[:2]
    if vtables.dtype != torch.int32 or not vtables.is_contiguous() \
            or vtables.device != dev:
        raise ValueError(f"paged_read: vtables must be a contiguous int32 "
                         f"(B, Wv) tensor on {dev}")
    for t in (lens, low_pos):
        if t.dtype != torch.int64 or tuple(t.shape) != (b,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"paged_read: lens and low_pos must be "
                             f"contiguous int64 ({b},) tensors on {dev}")
    for arena in arenas:
        if arena.dtype != cfg.storage_dtype or not arena.is_contiguous() \
                or arena.ndim < 3 or tuple(arena.shape[:2]) != (nb, bs) \
                or arena.device != dev:
            raise ValueError(f"paged_read: leaves must be contiguous "
                             f"{cfg.storage_dtype} ({nb}, {bs}, ...) arenas "
                             f"on {dev}, got {arena.dtype} "
                             f"{tuple(arena.shape)}")
    outs = [torch.empty((b, vw * bs) + tuple(a.shape[2:]), dtype=out_dtype,
                        device=dev) for a in arenas]
    fn = _build.load("posit_paged_read").posit_paged_read
    args = (cfg.nbits, _FLOAT_KINDS[out_dtype], len(arenas), arenas[0].data_ptr(),
            arenas[-1].data_ptr(), outs[0].data_ptr(), outs[-1].data_ptr(),
            arenas[0][0, 0].numel(), arenas[-1][0, 0].numel(), vtables.data_ptr(),
            lens.data_ptr(), low_pos.data_ptr(), b, vw, nb, bs,
            torch.cuda.current_stream(dev).cuda_stream)
    return (lambda: fn(*args)), outs


def paged_read(arenas, vtables: torch.Tensor, lens: torch.Tensor,
               low_pos: torch.Tensor, cfg: PositConfig,
               out_dtype: torch.dtype):
    """Gather, decode and mask one layer's posit leaves for a prefill
    chunk (:func:`paged_read_plain` for the layout); returns one
    (B, Wv * bs, *feat) tensor of ``out_dtype`` per leaf.

    On a CUDA tensor: one launch of ``csrc/posit_paged_read.cu`` for
    both leaves, posit16 or posit8 (es 2), f32 or bf16 out; blocks with
    no resident slot are not read.  The arenas' device chooses the
    path."""
    if arenas[0].device.type == "cpu":
        return paged_read_plain(arenas, vtables, lens, low_pos, cfg, out_dtype)
    call, outs = paged_read_call(arenas, vtables, lens, low_pos, cfg,
                                 out_dtype)
    _build.check(call(), "posit_paged_read")
    launches["posit_paged_read"] += 1
    return outs
