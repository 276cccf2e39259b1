"""Fused GroupNorm (+ affine, + optional ReLU) over NHWC tensors for the
port: hand-written CUDA kernels for the H100 (forward and backward) and
their plain PyTorch versions.

The kernels live in ``csrc/group_norm.cu`` and replace the Pallas TPU
kernels of the JAX package's ``ops/group_norm.py``: ``_fwd_kernel``
(:68, launched at :103) and ``_bwd_kernel`` (:137, launched at :187).
They are built with ``nvcc`` at first use (``_build.py``).
``group_norm_fwd`` and ``group_norm_bwd`` take the kernel for a CUDA
tensor and the plain version for a CPU tensor, and raise for anything
else: there is no fallback from the kernel to the plain version.

Numerics (the reference's, and ``flax.linen.GroupNorm``'s up to the
variance formula): float32 statistics over each (sample, group) of
``H * W * C / G`` values, biased variance, eps inside the square root, and
``y = ((x - mean) * rstd) * scale + bias``, then ``max(y, 0)`` if
``relu``; ``y`` has x's dtype. The forward saves the per-(sample, group)
mean and rstd ``[B, G]`` float32; the backward recomputes the ReLU mask
from x and those statistics with the forward's float32 formula, so no
extra tensor is saved.

Unlike the reference, where XLA's own GroupNorm fuses into the
neighbouring convolutions and the Pallas kernel is a fusion boundary, the
port's ResNet calls ``fused_group_norm`` at every norm: eager PyTorch
fuses nothing, and ``F.group_norm`` followed by ``relu`` would be several
separate passes over device memory.

Two paths on the card, chosen by the layout rule of the ``.cu``
(``cluster_size``, asked once per shape and alignment):

- one read (``group_norm_fwd``, ``group_norm_bwd``): a thread-block
  cluster of up to 8 blocks holds a (sample, channel tile) slab, the tile
  whole groups, in its shared memory; the statistics (forward) or the
  channel sums (backward) are added over the cluster's distributed shared
  memory and the output is written from shared memory. x (and dy) are
  read from device memory once: 4 bytes a bfloat16 value forward, 6
  backward, the bound's own traffic, in one launch. Every ResNet-50 norm
  site takes it, in both types and both directions; so does a tensor that
  is not 16-byte aligned (a view that starts mid-buffer), with loads as
  wide as its alignment allows.
- two reads (``group_norm_fwd_2pass``, ``group_norm_bwd_2pass``): for a
  slab beyond 8 blocks' shared memory (one group across a 256x256x32
  image, say) or a tile of more than 512 load-wide columns: three kernels
  a direction (a sweep writing ``[B, S, C]`` chunk partials, a merge per
  (sample, group), a sweep writing the output), 6 and 10 bytes a bfloat16
  value.

Each CUDA wrapper counts its launches in ``LAUNCHES``, one per call, under
the name of the path it took, so a run can show which kernels its path
went through.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from tfk8s_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

ONE_READ_KERNELS = ("group_norm_fwd", "group_norm_bwd")
TWO_READ_KERNELS = ("group_norm_fwd_2pass", "group_norm_bwd_2pass")
KERNELS = ONE_READ_KERNELS + TWO_READ_KERNELS
# launches of each kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _check(x: torch.Tensor, groups: int) -> None:
    """The reference's validation (``fused_group_norm``)."""
    if x.dim() != 4:
        raise NotImplementedError(
            f"fused_group_norm expects NHWC rank-4 input, got shape {tuple(x.shape)}"
        )
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")


# -- plain versions (CPU tensors; the card's yardstick) ----------------------


def _grouped(t: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, H, W, C] -> float32 [B, H*W, G, C/G]."""
    b, h, w, c = t.shape
    return t.float().reshape(b, h * w, groups, c // groups)


def group_norm_fwd_plain(x, scale, bias, groups: int, eps: float = 1e-6, relu: bool = False):
    """The forward kernel's function in PyTorch ops: ``(y, mean, rstd)``,
    two-pass float32 statistics, mean and rstd ``[B, G]``."""
    _check(x, groups)
    xf = _grouped(x, groups)
    mean = xf.mean(dim=(1, 3))
    d = xf - mean[:, None, :, None]
    rstd = torch.rsqrt(d.square().mean(dim=(1, 3)) + eps)
    cg = x.shape[-1] // groups
    y = d * rstd[:, None, :, None]
    y = y * scale.float().reshape(groups, cg) + bias.float().reshape(groups, cg)
    if relu:
        y = y.clamp_min(0.0)
    return y.reshape(x.shape).to(x.dtype), mean, rstd


def group_norm_bwd_plain(dy, x, scale, bias, mean, rstd, groups: int, relu: bool = False):
    """The backward kernel's function in PyTorch ops: ``(dx, dscale,
    dbias)`` with dscale, dbias float32 ``[C]``. The ReLU mask is the
    forward's float32 pre-ReLU output recomputed from x and the saved
    statistics (the reference's ``_bwd_kernel`` :156-161)."""
    _check(x, groups)
    b, h, w, c = x.shape
    cg = c // groups
    xhat = (_grouped(x, groups) - mean[:, None, :, None]) * rstd[:, None, :, None]
    gamma = scale.float().reshape(groups, cg)
    dz = _grouped(dy, groups)
    if relu:
        pre = xhat * gamma + bias.float().reshape(groups, cg)
        dz = torch.where(pre > 0, dz, torch.zeros((), dtype=dz.dtype))
    dxhat = dz * gamma
    n = h * w * cg
    s1 = dxhat.sum(dim=(1, 3), keepdim=True) / n
    s2 = (dxhat * xhat).sum(dim=(1, 3), keepdim=True) / n
    dx = rstd[:, None, :, None] * (dxhat - s1 - xhat * s2)
    dscale = (dz * xhat).sum(dim=(0, 1)).reshape(c)
    dbias = dz.sum(dim=(0, 1)).reshape(c)
    return dx.reshape(x.shape).to(x.dtype), dscale, dbias


# -- CUDA kernels ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("group_norm")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tfk8s_group_norm_cluster_size.argtypes = [I] * 7
    lib.tfk8s_group_norm_chunks.argtypes = [I, I]
    lib.tfk8s_group_norm_fwd.argtypes = [P] * 6 + [I] * 4 + [F] + [I] * 2 + [P]
    lib.tfk8s_group_norm_bwd.argtypes = [P] * 9 + [I] * 6 + [P]
    lib.tfk8s_group_norm_fwd_2pass.argtypes = [P] * 7 + [I] * 4 + [F] + [I] * 2 + [P]
    lib.tfk8s_group_norm_bwd_2pass.argtypes = [P] * 11 + [I] * 6 + [P]
    for fn in (lib.tfk8s_group_norm_cluster_size, lib.tfk8s_group_norm_chunks,
               lib.tfk8s_group_norm_fwd, lib.tfk8s_group_norm_bwd,
               lib.tfk8s_group_norm_fwd_2pass, lib.tfk8s_group_norm_bwd_2pass):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def cluster_size(shape, groups: int, dtype: torch.dtype, backward: bool, align: int = 16) -> int:
    """The blocks (1-8) of the thread-block cluster that holds one slab of
    an NHWC ``shape`` under the layout rule of the kernels' source, for
    tensors whose addresses are multiples of ``align`` bytes (``alignment``);
    0 when the launch takes the two-read path. Asked of the source once a
    shape and alignment."""
    b, h, w, c = shape
    return _lib().tfk8s_group_norm_cluster_size(b, h * w, c, groups, _DTYPE_CODES[dtype],
                                                int(backward), align)


def alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, at most 16, that divides every tensor's
    address: what the kernels' loads may assume."""
    return math.gcd(16, *(t.data_ptr() for t in tensors))


def kernel_name(shape, groups: int, dtype: torch.dtype, backward: bool, align: int = 16) -> str:
    """The ``LAUNCHES`` name that a launch on tensors of this NHWC shape,
    ``align`` bytes aligned, counts under."""
    one = cluster_size(tuple(shape), groups, dtype, backward, align) > 0
    return (ONE_READ_KERNELS if one else TWO_READ_KERNELS)[int(backward)]


def _reads_once(x: torch.Tensor, groups: int, backward: bool, *others) -> bool:
    """Whether a launch on x (and the other tensors) takes the one-read
    kernel."""
    return cluster_size(tuple(x.shape), groups, x.dtype, backward, alignment(x, *others)) > 0


def _partials(b: int, hw: int, c: int, device) -> torch.Tensor:
    """The [B, S, C, 2] float32 chunk partials of a two-read launch; the
    kernels' source decides S (and every other rule of the launch's
    layout)."""
    chunks = _lib().tfk8s_group_norm_chunks(b, hw)
    return torch.empty((b, chunks, c, 2), dtype=torch.float32, device=device)


def _check_cuda(x, scale, bias, groups, *others) -> None:
    _check(x, groups)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"group-norm kernels take float32 or bfloat16, got {x.dtype}")
    c = x.shape[-1]
    for t in (scale, bias):
        if t.shape != (c,) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("scale and bias must be contiguous float32 [C]")
    for t in (x, scale, bias, *others):
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
    if not x.is_contiguous():
        raise ValueError("group-norm kernels take contiguous NHWC tensors")


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def group_norm_fwd_cuda(x, scale, bias, groups: int, eps: float = 1e-6, relu: bool = False):
    """Launch the forward kernel: ``(y, mean, rstd)``."""
    _check_cuda(x, scale, bias, groups)
    b, h, w, c = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if x.numel() == 0:
        return y, mean, rstd
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (scale.data_ptr(), bias.data_ptr(), y.data_ptr(), mean.data_ptr(), rstd.data_ptr())
    shape = (b, h * w, c, groups, float(eps), int(relu), _DTYPE_CODES[x.dtype], stream)
    with torch.cuda.device(x.device):
        if _reads_once(x, groups, False, y):
            name = "group_norm_fwd"
            rc = _lib().tfk8s_group_norm_fwd(x.data_ptr(), *args, *shape)
        else:
            name = "group_norm_fwd_2pass"
            part = _partials(b, h * w, c, x.device)
            rc = _lib().tfk8s_group_norm_fwd_2pass(x.data_ptr(), *args, part.data_ptr(), *shape)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return y, mean, rstd


def group_norm_bwd_cuda(dy, x, scale, bias, mean, rstd, groups: int, relu: bool = False):
    """Launch the backward kernel: ``(dx, dscale, dbias)``. The kernel
    writes every entry of the per-sample ``[B, C]`` partials of dscale and
    dbias, side by side in one ``[2, B, C]`` buffer; their sum over B is one
    ``torch.sum`` here, as the reference leaves it to XLA (``_bwd_impl``
    :215)."""
    _check_cuda(x, scale, bias, groups, dy, mean, rstd)
    b, h, w, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("dy must be contiguous with x's shape and dtype")
    for t in (mean, rstd):
        if t.shape != (b, groups) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("mean and rstd must be contiguous float32 [B, G]")
    dx = torch.empty_like(x)
    if x.numel() == 0:
        zeros = torch.zeros(c, dtype=torch.float32, device=x.device)
        return dx, zeros, zeros.clone()
    partials = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (dy.data_ptr(), x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), dx.data_ptr(), partials.data_ptr(), partials.data_ptr() + 4 * b * c)
    shape = (b, h * w, c, groups, int(relu), _DTYPE_CODES[x.dtype], stream)
    with torch.cuda.device(x.device):
        if _reads_once(x, groups, True, dy, dx):
            name = "group_norm_bwd"
            rc = _lib().tfk8s_group_norm_bwd(*ptrs, *shape)
        else:
            name = "group_norm_bwd_2pass"
            part = _partials(b, h * w, c, x.device)
            moments = torch.empty((b, groups, 2), dtype=torch.float32, device=x.device)
            rc = _lib().tfk8s_group_norm_bwd_2pass(*ptrs, part.data_ptr(), moments.data_ptr(),
                                                   *shape)
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    dscale, dbias = partials.sum(1)
    return dx, dscale, dbias


# -- dispatch: the kernel on the card, the plain version on the CPU -----------


def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"group norm runs on cuda or cpu tensors, got {t.device}")


def group_norm_fwd(x, scale, bias, groups: int, eps: float = 1e-6, relu: bool = False):
    return _route(x, group_norm_fwd_cuda, group_norm_fwd_plain)(x, scale, bias, groups, eps, relu)


def group_norm_bwd(dy, x, scale, bias, mean, rstd, groups: int, relu: bool = False):
    return _route(x, group_norm_bwd_cuda, group_norm_bwd_plain)(
        dy, x, scale, bias, mean, rstd, groups, relu)


class FusedGroupNorm(torch.autograd.Function):
    """Forward kernel, then the backward kernel as its backward (the
    reference's ``_fused`` custom_vjp)."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups, eps, relu):
        s, b = scale.float().contiguous(), bias.float().contiguous()
        y, mean, rstd = group_norm_fwd(x, s, b, groups, eps, relu)
        ctx.save_for_backward(x, s, b, mean, rstd)
        ctx.groups, ctx.relu = groups, relu
        ctx.param_dtypes = (scale.dtype, bias.dtype)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, s, b, mean, rstd = ctx.saved_tensors
        # autograd may hand over a non-contiguous gradient (e.g. after a
        # permute); the kernel takes contiguous NHWC, so this copies then
        dx, ds, db = group_norm_bwd(dy.contiguous(), x, s, b, mean, rstd, ctx.groups, ctx.relu)
        return dx, ds.to(ctx.param_dtypes[0]), db.to(ctx.param_dtypes[1]), None, None, None


def reference_group_norm(x, scale, bias, groups: int, eps: float = 1e-6, relu: bool = False):
    """GroupNorm(+ReLU) in PyTorch ops, differentiated by autograd: the
    reference's ``reference_group_norm`` (flax-equivalent numerics)."""
    _check(x, groups)
    return group_norm_fwd_plain(x, scale, bias, groups, eps, relu)[0]


def fused_group_norm(x, scale, bias, groups: int, eps: float = 1e-6, relu: bool = False):
    """GroupNorm(+optional ReLU) over the channel-last dim of an NHWC
    tensor: the CUDA kernels on the card, their plain versions on the
    CPU. Differentiable in x, scale and bias. x must be contiguous NHWC
    on the card (a channels-last NCHW tensor permuted to NHWC is)."""
    _check(x, groups)
    return FusedGroupNorm.apply(x, scale, bias, groups, float(eps), bool(relu))


__all__ = [
    "KERNELS", "LAUNCHES", "ONE_READ_KERNELS", "TWO_READ_KERNELS", "FusedGroupNorm",
    "alignment", "cluster_size", "fused_group_norm", "group_norm_bwd", "group_norm_bwd_plain",
    "group_norm_fwd", "group_norm_fwd_plain", "kernel_name", "reference_group_norm",
    "reset_launches",
]
