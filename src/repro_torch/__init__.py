"""PyTorch/CUDA port of the Whisper Q8_0 offload system, beside the JAX
reference package ``repro``. It imports ``torch`` and ``numpy`` only —
nothing of JAX and nothing of the reference package.

Layout mirrors the reference: ``configs/``, ``core/``, ``backends/``,
``kernels/`` (with the CUDA sources in ``csrc/``), ``models/``, ``serve/``,
``launch/``.
"""
