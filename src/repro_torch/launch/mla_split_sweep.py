"""Time the MLA paged-decode kernel alone at several table entries per
split, on minicpm3-4b's decode case (B 8, H 40, rank 256, rope 32,
W 64, block 16, posit16 latents, the lens of ``chip_smoke.py``'s MLA
case): the sweep behind ``posit_paged_attn._MLA_CTAS_PER_SM``.

  PYTHONPATH=src python -m repro_torch.launch.mla_split_sweep --chunks 1 2 4 8

Needs a CUDA card.  Prints the card, the policy's choice, and one JSON
line ``{"<entries per split>": ms, ...}``: each time is 100 back-to-back
launches of the split and fold kernels on preallocated outputs, one
CUDA event pair, divided by 100.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import posit_codec as C
from repro_torch.kernels import posit_paged_attn as K
from repro_torch.launch.timing import kernel_alone_ms
from repro_torch.models import layers as L


def minicpm3_case(dev, kv: str = "posit16", seed: int = 4, h: int = 40):
    """Minicpm3-4b's full-width latent decode attention inputs: B 8 rows,
    H 40 heads (``h``: a rank's share under tensor parallelism, e.g. 20
    at mp 2), rank 256, rope 32, block 16, W 64 table slots; ragged
    lens, sentinel tails, one all-masked row (its table is all
    sentinels).  Returns the kernel's arguments and the posit config."""
    b, rank, rope, bs, w = 8, 256, 32, 16, 64
    lens = [1000, 700, 512, 300, 900, 64, 1020, 0]
    nb = b * w
    gen = torch.Generator(device=dev).manual_seed(seed)
    tables = torch.full((b, w), nb, dtype=torch.int32)
    perm = torch.randperm(nb, generator=torch.Generator().manual_seed(seed))
    for i, n in enumerate(lens[:-1]):
        live = -(-(n + 1) // bs)
        tables[i, :live] = perm[i * w:i * w + live].to(torch.int32)
    tables = tables.to(dev)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    apos = L.paged_apos(tables, lens, bs, nb)
    pcfg = L.pcfg(kv)
    c = C.quantize_plain(torch.randn((nb, bs, rank), generator=gen, device=dev), pcfg)
    r = C.quantize_plain(torch.randn((nb, bs, rope), generator=gen, device=dev), pcfg)
    q_lat = torch.randn((b, h, rank), generator=gen, device=dev)
    q_rope = torch.randn((b, h, rope), generator=gen, device=dev)
    return (q_lat, q_rope, c, r, tables, apos, lens), pcfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("mla_split_sweep needs a CUDA card")
    dev = torch.device("cuda")
    case, pcfg = minicpm3_case(dev)
    scale = (64 + 32) ** -0.5
    policy = K.split_chunk_mla(case[4].shape[1], case[0].shape[0], _build.sm_count(dev))
    times = {str(c): kernel_alone_ms(K.paged_decode_attention_mla_call(
        *case, pcfg=pcfg, scale=scale, chunk=c)[0]) for c in args.chunks}
    print(f"{torch.cuda.get_device_name(0)}; split_chunk_mla chooses {policy}")
    print(json.dumps(times))
    return times


if __name__ == "__main__":
    main()
