"""PyTorch + CUDA port of :mod:`repro` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout where that helps a reader find a module's counterpart.  It
imports ``torch``, numpy and the standard library only — never ``jax``
and never ``repro``: what it needs from the reference it keeps as its
own copy.

Every Pallas TPU kernel on the served path has a hand-written CUDA C++
kernel for ``sm_90a`` under ``csrc/``, built with ``nvcc`` at first use
(:mod:`repro_torch.kernels.build`) and bound through ``ctypes``.  Each
kernel wrapper launches its kernel for CUDA tensors and runs the plain
PyTorch version of the same function for CPU tensors, which is how the
CPU tests hold the port against the reference.

Entry points (``serving.api.build_engine``, ``serving.engine.Engine``,
``models.transformer.init_params``,
``kernels.packed_matmul.ops.prepack_dense``, the serve CLI
``launch.serve`` and the training CLI ``launch.train``) run on the card
unless the caller passes ``device="cpu"`` (``--device cpu``); without a
card they raise.  Training (``models.transformer.forward_train``,
``launch.steps.make_train_step``, ``optim``, ``runtime``) computes its
products in plain PyTorch with autograd, as the reference computes them
in XLA outside any Pallas kernel.
"""
