"""Hand-written CUDA kernels for the search loop's hot spots.

Each kernel package mirrors ``repro.kernels.<name>``: ``kernel.py`` binds
the CUDA C++ source in ``repro_torch/csrc/`` (built with nvcc for sm_90a
at first use and loaded with ctypes), ``ref.py`` is the plain PyTorch
version of the same function, and ``ops.py`` dispatches on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.  Nothing here falls back from the card to the CPU.
"""
