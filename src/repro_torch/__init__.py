"""PyTorch / CUDA port of the DDSketch bank service for NVIDIA Hopper.

Mirrors the JAX package's layout (``kernels``, ``core``, ``engine``,
``telemetry``, ``launch``) and imports nothing of it.  Entry points run on
the card (``device="cuda"``) unless the caller passes ``device="cpu"``;
the device of the bank decides whether a hand-written CUDA kernel or its
plain PyTorch version runs.
"""
