"""The gossip-mix kernels: CUDA C++ for ``sm_90a`` (``csrc/``, built by
``build``), their wrappers with launch counters (``ops``) and their plain
PyTorch versions (``ref``)."""
