"""Paper Listing 2: 4x4 convolution on the PVU, vectorized by rows.

The port of the reference's ``examples/posit_convolution.py``: every
output pixel's 16-tap window is one row, encoded to posit32 and reduced
with the PVU dot product (``ops.dot``: ``csrc/posit_dot.cu`` on the GPU,
the plain ``core.posit.vpdot`` on the CPU; one rounding per window),
exactly the paper's ``conv4x4_vectorized``.  The input is
int8-quantized activations/weights (the paper's section VI
methodology).  Output is compared against exact f64 convolution and
the golden model.  The bias-add epilogue runs on the fused elementwise
kernel (``ops.vadd``): conv output patterns + bias pattern stay in the
posit domain end to end.

  PYTHONPATH=src python -m repro_torch.examples.posit_convolution [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import softposit_ref as golden
from repro_torch.core.types import POSIT32
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

BIAS = 0.125


def conv4x4_posit(image, kernel, device="cuda"):
    """image: (H, W) f32; kernel: (4, 4) f32 -> ((H-3, W-3) f32, the
    same as uint32 posit32 patterns), all math in posit32 with the PVU
    dot product (single rounding per window)."""
    dev = resolve_device(device)
    h, w = image.shape
    oh, ow = h - 3, w - 3
    # im2col: every output pixel's 16-tap window as one row
    windows = np.lib.stride_tricks.sliding_window_view(image, (4, 4))
    rows = windows.reshape(oh * ow, 16).astype(np.float32)
    krow = np.broadcast_to(kernel.reshape(1, 16), (oh * ow, 16))
    pa = ops.quantize(torch.from_numpy(rows).to(dev), POSIT32)
    pb = ops.quantize(torch.from_numpy(krow.astype(np.float32)).to(dev), POSIT32)
    out = ops.dot(pa, pb, POSIT32)                  # the paper's vpdot instruction
    return (ops.dequantize(out, POSIT32).cpu().numpy().reshape(oh, ow),
            out.cpu().numpy().astype(np.uint32))


def inputs():
    """The paper's int8-quantized first-conv data (seed 7)."""
    rng = np.random.default_rng(7)
    image = (rng.integers(0, 128, (32, 32)) * 0.02).astype(np.float32)
    kernel = (rng.integers(-127, 128, (4, 4)) * 0.005).astype(np.float32)
    return image, kernel


def run(device="cuda") -> dict:
    dev = resolve_device(device)
    image, kernel = inputs()
    out_posit, out_patterns = conv4x4_posit(image, kernel, dev)

    # exact reference in f64
    ref = np.zeros((29, 29))
    for i in range(29):
        for j in range(29):
            ref[i, j] = np.sum(image[i:i + 4, j:j + 4].astype(np.float64)
                               * kernel.astype(np.float64))
    abs_err = np.abs(out_posit - ref)
    rel = abs_err.max() / max(np.abs(ref).max(), 1e-12)
    # quire exactness: each window must be the correctly rounded posit32
    # of the exact real dot product (paper claim: 100 % for vpdot)
    want = np.array([golden.from_float(float(v), POSIT32)
                     for v in ref.reshape(-1)], np.uint32)
    exact_pct = float((out_patterns.reshape(-1) == want).mean())

    # bias-add epilogue: fused posit vadd, checked against the golden
    # model per element
    bias_pat = golden.from_float(BIAS, POSIT32)
    pats = torch.from_numpy(out_patterns.astype(np.int64)).to(dev)
    with_bias = ops.vadd(pats, torch.tensor(bias_pat, device=dev), POSIT32)
    with_bias_np = with_bias.cpu().numpy().astype(np.uint32)
    want_bias = np.array([golden.add(int(p), bias_pat, POSIT32)
                          for p in out_patterns.reshape(-1)],
                         np.uint32).reshape(with_bias_np.shape)
    f_bias = ops.dequantize(with_bias, POSIT32).cpu().numpy()
    return dict(out_posit=out_posit, out_patterns=out_patterns,
                max_abs_err=float(abs_err.max()), rel=float(rel), exact_pct=exact_pct,
                bias_exact=bool((with_bias_np == want_bias).all()),
                n_out=int(with_bias_np.size), bias_mean=float(f_bias.mean()),
                mean=float(out_posit.mean()))


def check(res: dict) -> None:
    assert res["rel"] < 1e-6 and res["exact_pct"] == 1.0, (res["rel"], res["exact_pct"])
    assert res["bias_exact"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    print("conv 32x32 * 4x4 -> 29x29 via PVU vpdot")
    print(f"max abs err vs f64:     {res['max_abs_err']:.3e}")
    print(f"max rel err vs f64:     {res['rel']:.3e}")
    print(f"correctly-rounded:      {100 * res['exact_pct']:.2f}% of windows "
          f"(single rounding per window)")
    check(res)
    print(f"fused bias-add (+{BIAS}): exact on {res['n_out']}/{res['n_out']} outputs, "
          f"mean={res['bias_mean']:.4f} (unbiased mean={res['mean']:.4f})")
    print("OK")


if __name__ == "__main__":
    main()
