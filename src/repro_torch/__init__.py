"""PyTorch / CUDA port of the PVU serving stack.

A second package beside ``repro`` (the JAX reference, which it never
imports).  Plain tensor code is PyTorch; the reference's Pallas TPU
kernels on the serving path are hand-written CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version beside its wrapper.

Entry points run on the GPU (``device="cuda"``) unless the caller asks
for the CPU; on the CPU every kernel wrapper runs its plain version.
"""
