"""The port's kernels: hand-written CUDA (``csrc/``) behind ops.py.

``ops.py`` holds the public entry points, ``dispatch.py`` the impl
resolution, ``ref.py`` the plain PyTorch versions, ``build.py`` the nvcc
build, and one wrapper module per CUDA kernel.
"""
