"""PyTorch/CUDA port of the AdHash RDF engine (``repro``), for NVIDIA Hopper.

Mirrors the JAX package's layout: ``repro_torch.core`` holds the engine's
modules, ``repro_torch.kernels`` the wrappers of the hand-written CUDA
kernels whose sources live in ``repro_torch/csrc``, ``repro_torch.data``
the synthetic data generators, ``repro_torch.models``,
``repro_torch.configs`` and ``repro_torch.launch`` the dense LM and its
serving entry points.  The port imports torch and numpy only —
never jax, never ``repro``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead (the reference the kernels are held to).
"""
