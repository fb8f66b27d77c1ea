"""Cross-pod posit gradient compression: convergence demonstration.

The port of the reference's ``examples/gradient_compression.py``: the
same small LM (internvl2-1b reduced, no visual tokens) trained twice --
exact f32 gradients against error-feedback posit8-compressed gradients
(the cross-pod wire format, ``compress.gradient``: the codec's quantize
and dequantize, ``csrc/posit_codec.cu``, on the GPU) -- the loss curves
stay together while the wire bytes drop 4x.

  PYTHONPATH=src python -m repro_torch.examples.gradient_compression [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch import configs
from repro_torch import tree as T
from repro_torch.compress import gradient as gc
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.device import resolve_device
from repro_torch.models import get_family
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

STEPS = 120


def train(cfg, pipe, dev, compress: bool, steps: int = STEPS):
    """``steps`` AdamW steps from the seed's weights; returns the losses
    and the bytes the gradients put on the wire."""
    opt_cfg = adamw.AdamWConfig(lr=1e-3, weight_decay=0.0)
    # the whole batch in one backward, as the reference's value_and_grad
    grad_fn = train_loop.make_grad_fn(cfg, accum=1)
    params = get_family(cfg).init_params(cfg, seed=0, device=dev)
    state = adamw.init(params, opt_cfg)
    ef = gc.init_error_state(params) if compress else None
    losses, wire_bytes = [], 0
    for step in range(steps):
        loss, grads = grad_fn(params, pipe.batch_at(step))
        if compress:
            q, ef = gc.compress_with_feedback(grads, ef, "posit8")
            wire_bytes += sum(x.numel() * x.element_size() for x in T.leaves(q))
            grads = gc.decompress(q, "posit8")
        else:
            wire_bytes += sum(x.numel() * 4 for x in T.leaves(grads))
        params, state, _ = adamw.update(grads, state, params, opt_cfg)
        losses.append(float(loss))
    return losses, wire_bytes


def run(device="cuda", steps: int = STEPS) -> dict:
    dev = resolve_device(device)
    cfg = configs.get_config("internvl2-1b").reduced(
        compute_dtype="float32", n_visual_tokens=0)
    pipe = Pipeline(DataConfig(seed=11), cfg, 16, 64, device=dev)
    base, bytes_f32 = train(cfg, pipe, dev, False, steps)
    comp, bytes_p8 = train(cfg, pipe, dev, True, steps)
    return dict(base=base, comp=comp, bytes_f32=bytes_f32, bytes_p8=bytes_p8)


def check(res: dict) -> None:
    base, comp = res["base"], res["comp"]
    assert comp[-1] < base[0] * 0.8, "compressed run failed to learn"
    assert abs(comp[-1] - base[-1]) < 0.35 * base[0], "compressed diverged from exact"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    base, comp = res["base"], res["comp"]
    print(f"{'step':>5} {'f32 loss':>10} {'posit8+EF loss':>15}")
    for i in range(0, len(base), 20):
        print(f"{i:>5} {base[i]:>10.4f} {comp[i]:>15.4f}")
    print(f"final: f32={base[-1]:.4f}  posit8+EF={comp[-1]:.4f}")
    print(f"wire bytes: f32={res['bytes_f32']:,}  posit8={res['bytes_p8']:,} "
          f"({res['bytes_f32'] / res['bytes_p8']:.1f}x less)")
    check(res)
    print("OK")


if __name__ == "__main__":
    main()
