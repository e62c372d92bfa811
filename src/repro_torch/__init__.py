"""ObjectCache on PyTorch and CUDA: the layerwise warm-hit serving path for
one NVIDIA H100 (Hopper, sm_90a).

A second package beside the JAX reference ``repro``; it imports torch, numpy
and the standard library only.  The storage side (``core``, ``codec``,
``hybrid``, ``obs``, ``fleet.policy``) is a copy of the reference's
framework-free modules, so the wire format is byte-identical; the model and
serving side is written in PyTorch, and the KV dequant kernels are CUDA C++
(``kernels/csrc``).  Entry points run on ``device="cuda"`` unless the caller
asks for the CPU.
"""
