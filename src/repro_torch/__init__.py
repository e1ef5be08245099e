"""ExSample on PyTorch and CUDA: the port of ``repro`` to an NVIDIA H100.

The package mirrors ``repro``'s layout module for module.  Tensors live
on the device an entry point is given (``device="cuda"`` by default;
``repro_torch.device.resolve`` raises when no card is present rather than
running on the CPU).  The two hot spots of the search loop, the Thompson
chunk choice and the matcher's IoU matrix, are hand-written CUDA kernels
(``csrc/``) behind dispatchers that pick the kernel for a CUDA tensor and
the plain PyTorch version for a CPU tensor.
"""
