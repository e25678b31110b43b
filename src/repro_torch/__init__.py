"""PyTorch/CUDA port of the static B-BENU main path.

Mirrors ``src/repro`` module by module (``repro_torch/core/plangen.py`` is
the counterpart of ``repro/core/plangen.py``) but imports nothing from it
and never imports jax. Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
