"""PyTorch + CUDA port of ``repro``.

The package mirrors ``repro``'s file layout (``repro_torch.models.layers``
is the counterpart of ``repro.models.layers``, and so on).  It imports
``torch`` and never ``jax`` or anything of ``repro``: modules of ``repro``
that do not need JAX are kept here as copies.  Every Pallas TPU kernel on
a ported path is a CUDA C++ kernel under ``kernels/csrc/``, built with
``nvcc`` at first use.  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``, where the kernels' plain PyTorch versions run.
"""
