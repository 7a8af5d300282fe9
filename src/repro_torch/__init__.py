"""HASCO on PyTorch and CUDA for one NVIDIA H100: the port of ``repro``.

Same layout and names as the JAX package (``core``, ``kernels``, ``tuner``,
``obs``, ``ft``, ``analysis``); the four intrinsic kernels are hand-written
CUDA C++ for ``sm_90a``.  Entry points run on the card unless the caller
asks for the CPU (``device="cpu"``, ``implementation="torch"``), and a
request for the card where there is none raises.
"""
