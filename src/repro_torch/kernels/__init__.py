"""The port's kernels (three gossip mixes, flash attention, the MoE
router): CUDA C++ for ``sm_90a`` (``csrc/``, built by ``build``), their
wrappers with launch counters (``ops``) and their plain PyTorch versions
(``ref``)."""
