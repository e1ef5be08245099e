"""Checks shared by the ctypes launch wrappers."""
from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels.build import load


def require_cuda_f32(name: str, t: torch.Tensor, ndim: int, device: torch.device | None = None) -> None:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {getattr(t, 'device', type(t))}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def bind(lib_name: str, fn_name: str, argtypes: list, restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C entry point ``fn_name`` of ``lib_name`` with its signature set
    (ctypes would otherwise pass pointers as 32-bit ints)."""
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = argtypes
    fn.restype = restype
    return fn


_count_lock = threading.Lock()


def count_launch(wrapper, body: str | None = None, shape: tuple | None = None) -> None:
    """Add one to ``wrapper.launches`` (and to ``launches_by_body[body]``
    and ``launches_by_shape[shape]``) under a lock: the async runtime's
    workers launch from several threads."""
    with _count_lock:
        wrapper.launches += 1
        if body is not None:
            wrapper.launches_by_body[body] += 1
        if shape is not None:
            wrapper.launches_by_shape[shape] = wrapper.launches_by_shape.get(shape, 0) + 1


def check_status(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
