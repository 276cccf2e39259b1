"""Row-block copy of a float32 ``[rows, cols]`` tensor: the hand-written
CUDA kernel of the roofline probe's copy bandwidth, and its plain version.

The kernel lives in ``csrc/block_copy.cu`` and replaces the Pallas kernel
of the JAX package's ``tools/roofline.py:pallas_copy_gbps``; it is built
with ``nvcc`` at first use (``_build.py``). ``block_copy`` launches it for
a CUDA tensor and takes the plain version (``out.copy_(x)``) for a CPU
tensor, and raises for anything else. The wrapper counts its launches in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tfk8s_tpu_torch.ops import _build

BLOCK_ROWS = 8  # rows a block copies: 1024 blocks of 256 KB at [8192, 8192]

KERNELS = ("block_copy",)
# launches of each kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _check(x: torch.Tensor, out: torch.Tensor) -> None:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"block copy takes a float32 [rows, cols] tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if out.shape != x.shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError("out must match x's shape, dtype and device")


def block_copy_plain(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops."""
    out = torch.empty_like(x) if out is None else out
    _check(x, out)
    return out.copy_(x)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("block_copy")
    lib.tfk8s_block_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.tfk8s_block_copy.restype = ctypes.c_int
    return lib


def block_copy_cuda(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch the copy kernel: ``out`` (allocated when None) holds x."""
    out = torch.empty_like(x) if out is None else out
    _check(x, out)
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("block copy takes contiguous tensors")
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("block copy takes 16-byte aligned tensors")
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        rc = _lib().tfk8s_block_copy(x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
                                     BLOCK_ROWS, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"block_copy kernel launch failed: cudaError {rc}")
    LAUNCHES["block_copy"] += 1
    return out


def block_copy(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Copy x into ``out`` (a new tensor when None): the kernel on the
    card, the plain version on the CPU."""
    if x.is_cuda:
        return block_copy_cuda(x, out)
    if x.device.type == "cpu":
        return block_copy_plain(x, out)
    raise ValueError(f"block copy runs on cuda or cpu tensors, got {x.device}")


__all__ = ["BLOCK_ROWS", "KERNELS", "LAUNCHES", "block_copy", "block_copy_cuda",
           "block_copy_plain", "reset_launches"]
