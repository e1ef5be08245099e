"""The LM of the serving path (``transformer``, every family of
``ARCHS``), its layers, its attention, which runs through kernels B4
(prefill) and B5 (decode), its Mamba-2 block (``mamba2``), whose SSD runs
through kernel B6 (prefill), its MoE block (``moe``), the stacked forward
(``stacked``), and the detection head and surrogate (``detection``)."""
