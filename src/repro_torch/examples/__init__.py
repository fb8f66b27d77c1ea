"""The reference's six examples on the port, one module each.

``quickstart``, ``posit_convolution``, ``serve_posit_kv``,
``gradient_compression``, ``train_lm`` and ``elastic_restart`` keep the
reference's configs, seeds, sizes, step counts and self-checks.  Each
module's ``run(device, ...)`` returns what the example checks and its
``main()`` prints it and asserts the self-check::

    PYTHONPATH=src python -m repro_torch.examples.quickstart             # on the GPU
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Every example runs on the GPU (``--device cuda``, the default) unless
asked for the CPU, and raises on a host without a GPU otherwise.
"""
