"""PyTorch/CUDA port of the jepsen_tpu linearizability checker.

The package stands beside ``jepsen_tpu`` (the JAX reference) and imports
nothing of it: history encoding, models, the host WGL oracle, the device
breadth-first search as plain torch ops, and the fused level loop as a
hand-written CUDA kernel for Hopper (``csrc/level_loop.cu``).

Entry points take an explicit ``device`` (default ``"cuda"``); without a
card they raise rather than run on the CPU, unless the caller asks for
``device="cpu"`` (the tests do).
"""
