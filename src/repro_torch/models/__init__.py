"""The LM of the serving path (``transformer``, dense and ssm families),
its layers, its attention, which runs through kernels B4 (prefill) and B5
(decode), and its Mamba-2 block (``mamba2``), whose SSD runs through kernel
B6 (prefill)."""
