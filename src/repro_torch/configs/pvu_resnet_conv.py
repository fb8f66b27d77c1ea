"""The paper's own verification workload: quantized first-conv data from a
ResNet-18-shaped network, evaluated with the PVU ops (benchmarks use this
config; it is not an LM arch).
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class ConvWorkload:
    in_channels: int = 3
    out_channels: int = 64
    kernel: int = 7
    image: int = 224
    stride: int = 2
    quant_scale: float = 0.02     # int8-style uniform quantization step


CONFIG = ConvWorkload()
