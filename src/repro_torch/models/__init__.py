"""The dense LM of the serving path (``transformer``), its layers and its
attention, which runs through kernels B4 (prefill) and B5 (decode)."""
