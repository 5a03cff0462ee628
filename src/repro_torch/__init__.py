"""The three-way chain join engine on PyTorch and CUDA.

A port of the JAX package ``repro`` to PyTorch for one NVIDIA H100:
the same relations, shuffles, joins, aggregations, cost model and
planner, batched over a simulated reducer grid (``core.SimGrid``), with
hand-written CUDA kernels (``kernels``) where the JAX package has
Pallas TPU kernels.  It imports neither JAX nor ``repro``.

Entry points build their tensors on the GPU unless the caller passes
``device="cpu"``; every operator after that follows its inputs' device.
"""
