"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper runs the plain version for a tensor on the CPU and launches
its kernel (or raises) for a tensor on a CUDA device; ``launches`` in
each module counts kernel launches.
"""
