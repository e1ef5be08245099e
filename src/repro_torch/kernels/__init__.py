"""Hand-written CUDA kernels for the search loop's and the LM's hot spots.

Each kernel package mirrors ``repro.kernels.<name>``: ``kernel.py`` binds
the CUDA C++ source in ``repro_torch/csrc/`` (built with nvcc for sm_90a
at first use and loaded with ctypes), ``ref.py`` is the plain PyTorch
version of the same function, and ``ops.py`` dispatches on the tensor's
device: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel or raises.  Nothing here falls back from the card to the CPU.
"""


def counted_wrappers() -> dict:
    """Every kernel wrapper of the port by name.  Each adds one to its
    ``launches`` where it launches its kernel (a call captured into a CUDA
    graph counts once, however often the graph replays)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention, flash_attention_bwd
    from repro_torch.kernels.flash_decode.kernel import flash_decode
    from repro_torch.kernels.iou_match.kernel import (iou_matrix, iou_matrix_batched, match_update,
                                                      match_update_batched)
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan
    from repro_torch.kernels.thompson.kernel import (thompson_choose, thompson_choose_batched, thompson_round,
                                                     thompson_round_batched)

    return {"thompson_choose": thompson_choose, "thompson_choose_batched": thompson_choose_batched,
            "thompson_round": thompson_round, "thompson_round_batched": thompson_round_batched,
            "iou_matrix": iou_matrix, "iou_matrix_batched": iou_matrix_batched,
            "match_update": match_update, "match_update_batched": match_update_batched,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "flash_decode": flash_decode, "ssd_scan": ssd_scan}


def launch_counts() -> dict:
    """``launches`` of every kernel wrapper, by name."""
    return {name: fn.launches for name, fn in counted_wrappers().items()}
