"""PyTorch/CUDA port of the STEP N:M sparsity system (serving path).

Mirrors ``repro`` sub-package for sub-package (``repro_torch.models.model``
is the counterpart of ``repro.models.model``) and never imports JAX or any
module of ``repro``: the JAX package is the reference the tests hold this
one against.  The two kernels on the serving path, ``nm_spmm`` and
``paged_attn``, are hand-written CUDA for Hopper (``csrc/``); every other
op is plain PyTorch.
"""
