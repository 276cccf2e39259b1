"""PyTorch/CUDA port of the JAX package ``tfk8s_tpu`` for NVIDIA H100.

The JAX package stays in the repository as the reference; this package
mirrors its layout (``models/``, ``ops/``, ``runtime/``, ``utils/``) and
imports ``torch`` and numpy, never JAX and nothing of ``tfk8s_tpu``.
Entry points run on the card unless the caller asks for the CPU
(``TFK8S_DEVICE=cpu`` or a ``device=`` argument).
"""
