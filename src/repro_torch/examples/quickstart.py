"""Quickstart: the PVU vector ISA in five minutes, on the port.

The port of the reference's ``examples/quickstart.py``: the five paper
ops (vpadd/vpsub/vpmul/vpdiv/vpdot) on posit32 vectors (``core.posit``,
plain tensor code), f32 conversion, exactness against the golden model
(``core.softposit_ref``), the codec through ``ops.quantize`` /
``ops.dequantize`` (``csrc/posit_codec.cu`` on the GPU) and the fused
elementwise ops ``ops.vadd/vmul/vdiv`` on posit patterns
(``csrc/posit_ew.cu``), with no f32 round-trip.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import softposit_ref as golden
from repro_torch.core.posit import (POSIT8, POSIT16, POSIT32, f32_to_posit,
                                    posit_to_f32, quant_dequant, vpadd, vpdiv,
                                    vpdot, vpmul, vpsub)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

X = [3.14159, -0.001, 42.0, 1e6, -1e-6]
A = [1.5, 2.25, -3.0, 0.125]
B = [2.0, -0.5, 0.75, 8.0]
EXACT_DOT = 0.625          # 3 - 1.125 - 2.25 + 1


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def isa_table(dev) -> dict:
    """Sections 1-2: posit32 conversion and the five ISA ops on ``A``,
    ``B``; patterns as uint32 numpy arrays, values as f32."""
    x = torch.tensor(X, dtype=torch.float32, device=dev)
    p32 = f32_to_posit(x, POSIT32)
    a = f32_to_posit(torch.tensor(A, dtype=torch.float32, device=dev), POSIT32)
    b = f32_to_posit(torch.tensor(B, dtype=torch.float32, device=dev), POSIT32)
    out = {"x": _host(p32).astype(np.uint32),
           "back": _host(posit_to_f32(p32, POSIT32)),
           "posit16_roundtrip": _host(quant_dequant(x, POSIT16)),
           "posit8_roundtrip": _host(quant_dequant(x, POSIT8))}
    for name, fn in (("vpadd", vpadd), ("vpsub", vpsub), ("vpmul", vpmul),
                     ("vpdiv", vpdiv)):
        out[name] = _host(fn(a, b, POSIT32)).astype(np.uint32)
    out["vpdot"] = _host(vpdot(a[None, :], b[None, :], POSIT32)).astype(np.uint32)
    return out


def run(device="cuda") -> dict:
    """Every section's results (numpy and Python values)."""
    dev = resolve_device(device)
    res = {"isa": isa_table(dev)}
    res["dot"] = float(posit_to_f32(torch.from_numpy(
        res["isa"]["vpdot"].astype(np.int64)), POSIT32)[0])

    # 3. exactness against the golden model
    rng = np.random.default_rng(0)
    pa = rng.integers(0, 2 ** 32, 500, dtype=np.uint32)
    pb = rng.integers(0, 2 ** 32, 500, dtype=np.uint32)
    got = _host(vpmul(torch.from_numpy(pa.astype(np.int64)).to(dev),
                      torch.from_numpy(pb.astype(np.int64)).to(dev),
                      POSIT32)).astype(np.uint32)
    want = np.array([golden.mul(int(x), int(y), POSIT32)
                     for x, y in zip(pa, pb)], np.uint32)
    res["golden_match"] = float((got == want).mean())

    # 4. the codec kernel
    m = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(dev)
    patterns = ops.quantize(m, POSIT16)
    back = ops.dequantize(patterns, POSIT16)
    res["codec_dtype"] = str(patterns.dtype)
    res["codec_rel_err"] = float((back - m).abs().max() / m.abs().max())

    # 5. fused elementwise kernels: decode -> PIR op -> encode in one pass
    m2 = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32)).to(dev)
    q2 = ops.quantize(m2, POSIT16)
    fused = ops.vadd(patterns, q2, POSIT16)
    # the round trip the fused vadd replaces, shown for comparison
    roundtrip = ops.quantize(ops.dequantize(patterns, POSIT16) +  # positcheck: disable=PVU002
                             ops.dequantize(q2, POSIT16), POSIT16)
    res["fused_eq_roundtrip"] = float((fused == roundtrip).float().mean())
    half = ops.quantize(torch.tensor(0.5, device=dev), POSIT16)    # scalar broadcast
    scaled = ops.vmul(patterns, half, POSIT16)
    res["scalar_vmul_err"] = float((ops.dequantize(scaled, POSIT16) - back * 0.5).abs().max())
    ratio = ops.vdiv(patterns, q2, POSIT16, mode="exact")
    res["vdiv_nar"] = int((ratio == POSIT16.nar_pattern).sum())
    res["vdiv_size"] = ratio.numel()
    return res


def check(res: dict) -> None:
    """The self-check: vpmul exact against the golden model and vpdot
    the exact dot product."""
    assert res["golden_match"] == 1.0, res["golden_match"]
    assert res["dot"] == EXACT_DOT, res["dot"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.device)
    isa = res["isa"]
    print("=== 1. float -> posit -> float ===")
    print("f32     :", np.asarray(X, np.float32))
    print("posit32 :", [hex(int(v)) for v in isa["x"]])
    print("back    :", isa["back"])
    print("posit16 roundtrip:", isa["posit16_roundtrip"])
    print("posit8  roundtrip:", isa["posit8_roundtrip"])
    print("\n=== 2. the five PVU ops (paper Table II ISA) ===")
    for name in ("vpadd", "vpsub", "vpmul", "vpdiv"):
        vals = posit_to_f32(torch.from_numpy(isa[name].astype(np.int64)), POSIT32)
        print(f"{name}: {_host(vals)}")
    print("vpdot:", res["dot"], " (exact: 3 - 1.125 - 2.25 + 1 = 0.625)")
    print("\n=== 3. exactness vs the golden model ===")
    print(f"vpmul matches golden on {100 * res['golden_match']:.2f}% "
          f"of 500 random posit32 pairs")
    print("\n=== 4. the codec kernel ===")
    print(f"quantize->dequantize (64x128): storage {res['codec_dtype']}, "
          f"max rel err {res['codec_rel_err']:.2e}")
    print("\n=== 5. fused elementwise kernels (stay in the posit domain) ===")
    print(f"fused vadd == dequant->f32 add->requant on "
          f"{100 * res['fused_eq_roundtrip']:.2f}% of 64x128 "
          f"(fused rounds once, the round-trip twice)")
    print(f"fused scalar vmul by 0.5: max |fused - f32 path| = "
          f"{res['scalar_vmul_err']:.2e}")
    print(f"fused exact vdiv: {res['vdiv_nar']} NaR lanes (x/0) out of "
          f"{res['vdiv_size']}")
    check(res)
    print("OK")


if __name__ == "__main__":
    main()
