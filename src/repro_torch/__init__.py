"""PyTorch/CUDA port of the streaming speech-enhancement system.

Mirrors the layout of the JAX reference package ``repro`` (for example
``repro_torch/serve/deploy.py`` is the counterpart of
``repro/serve/deploy.py``) and imports nothing from it or from JAX. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; kernel
wrappers launch hand-written CUDA kernels on CUDA tensors and use their
plain PyTorch versions on CPU tensors (see ``kernels/runtime.py``).
"""
