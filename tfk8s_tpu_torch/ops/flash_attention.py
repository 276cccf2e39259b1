"""Flash attention for the port: hand-written CUDA kernels for the H100
and their plain PyTorch versions.

bfloat16 inputs (the training path) take the tensor-core kernels of
``csrc/flash_attention_sm90.cu``: a wgmma/TMA forward, and a backward
that runs one pre-pass for ``D = rowsum(dO * O)`` and ``lse * log2(e)``
and feeds it to both the wgmma/TMA dq and the wgmma/TMA dk/dv. float32
inputs take the CUDA-core forward, dq and dk/dv of
``csrc/flash_attention.cu``, which keep float32 exact and compute D
themselves. All replace the Pallas TPU kernels of the JAX package's
``ops/flash_attention.py`` and are built with ``nvcc`` at first use
(``_build.py``). Each function here takes its kernel for a CUDA tensor
and its plain version for a CPU tensor, and raises for anything else:
there is no fallback from one kernel to another or to the plain version.

Contract (the JAX package's ``flash_attention``):
- layout ``[b, l, h, d]``; q arrives pre-scaled by ``1/sqrt(d)``;
- ``mask`` is ``[b, lk]`` key validity (True = attend); other mask shapes
  raise ``NotImplementedError``;
- causal masking is bottom-right aligned (query i sees keys up to
  ``i + lk - lq``) and needs ``lq <= lk``;
- a query row whose keys are all masked gives zero output and zero grads.

The forward saves the per-row logsumexp (``[b, h, lq]`` float32) only
when a backward will follow; the backward (``flash_bwd``) recomputes
probabilities from (q, k, lse) and ``D = rowsum(dO * O)`` from (dO, O),
as the reference's kernels do. Unlike the Pallas kernels, the CUDA
kernels take any sequence length (they mask the ragged edge) and pick
their own tiles for the H100, so this module has no block-size arguments
and no ``pick_blocks``. The tensor-core kernels read through TMA, which needs
16-byte aligned tensors; their wrappers raise on any other.

Each wrapper counts its launches in ``LAUNCHES`` so a run can show that
its path went through the kernels, and which ones.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tfk8s_tpu_torch.ops import _build

_NEG = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# the backward pre-pass pads each (batch, head) row of D and lse to this
DSUM_PAD = 64

# Above this sequence length "auto" attention picks the kernels on the
# card (the same policy as the JAX package).
FLASH_SEQ_THRESHOLD = 1024

HEAD_DIMS = (16, 32, 64, 128)  # the head widths the kernels are built for
_DTYPES = (torch.float32, torch.bfloat16)

# bfloat16 on the tensor cores; float32 on the CUDA cores (SIMT)
TENSOR_CORE_KERNELS = ("flash_fwd_wgmma", "flash_bwd_dsum", "flash_bwd_dq_wgmma",
                       "flash_bwd_dkv_wgmma")
SIMT_KERNELS = ("flash_fwd_simt", "flash_bwd_dq_simt", "flash_bwd_dkv_simt")
KERNELS = TENSOR_CORE_KERNELS + SIMT_KERNELS
# launches of each kernel since the last reset_launches()
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


# -- plain versions (CPU tensors; the card's yardstick) ----------------------
# They work in powers of two, as the kernels do: exp2 and log2, never exp
# and log. On the CPU PyTorch evaluates float32 exp and log with MKL's VML,
# whose first multithreaded call in a process has been seen to return
# results ~1e-4 off (relative) on the card machine's host; exp2 and log2
# run PyTorch's own vectorized code.


def _visible(q, k, mask, causal) -> Optional[torch.Tensor]:
    """[b or 1, 1, lq, lk] bool of the (query, key) pairs attention may
    use, or None when every pair is visible."""
    lq, lk = q.shape[1], k.shape[1]
    vis = None
    if causal:
        vis = torch.ones(lq, lk, dtype=torch.bool, device=q.device).tril(lk - lq)
        vis = vis[None, None]
    if mask is not None:
        m = mask.to(device=q.device, dtype=torch.bool)[:, None, None, :]
        vis = m if vis is None else vis & m
    return vis


def flash_fwd_plain(q, k, v, mask=None, causal=False, save_lse=True):
    """The forward kernel's function in PyTorch ops: ``(o, lse or None)``,
    contiguous like the kernel's, so either feeds either backward."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    vis = _visible(q, k, mask, causal)
    if vis is not None:
        s = s.masked_fill(~vis, _NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp2((s - m) * LOG2E)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)  # a fully masked row has exp(0) = 1
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.permute(0, 2, 1, 3)
    lse = (m + torch.log2(l) * LN2).squeeze(-1).contiguous() if save_lse else None
    return o.to(q.dtype).contiguous(), lse


def _probs_and_ds(q, k, v, do, o, lse, mask, causal):
    """Recomputed probabilities p and ds = p * (dO.V^T - D), float32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp2((torch.einsum("bqhd,bkhd->bhqk", qf, kf) - lse[..., None]) * LOG2E)
    vis = _visible(q, k, mask, causal)
    if vis is not None:
        p = p.masked_fill(~vis, 0.0)
    dsum = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]  # [b,h,lq,1]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    return p, p * (dp - dsum)


def _dq_of(ds, q, k):
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype).contiguous()


def _dkv_of(p, ds, q, k, v, do):
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dk.to(k.dtype).contiguous(), dv.to(v.dtype).contiguous()


def flash_bwd_dq_plain(q, k, v, do, o, lse, mask=None, causal=False):
    """The dq kernel's function in PyTorch ops."""
    _, ds = _probs_and_ds(q, k, v, do, o, lse, mask, causal)
    return _dq_of(ds, q, k)


def flash_bwd_dkv_plain(q, k, v, do, o, lse, mask=None, causal=False):
    """The dk/dv kernel's function in PyTorch ops: ``(dk, dv)``."""
    p, ds = _probs_and_ds(q, k, v, do, o, lse, mask, causal)
    return _dkv_of(p, ds, q, k, v, do)


def flash_bwd_plain(q, k, v, do, o, lse, mask=None, causal=False):
    """The whole backward in PyTorch ops: ``(dq, dk, dv)``, with the
    probabilities recomputed once for all three."""
    p, ds = _probs_and_ds(q, k, v, do, o, lse, mask, causal)
    return (_dq_of(ds, q, k), *_dkv_of(p, ds, q, k, v, do))


def _padded(lq: int) -> int:
    return -(-lq // DSUM_PAD) * DSUM_PAD


def flash_bwd_dsum_plain(do, o, lse):
    """The backward pre-pass's function: ``(dsum, lse2)``, each
    ``[b * h, lqp]`` float32 with lqp = lq rounded up to DSUM_PAD.
    ``dsum = rowsum(dO * O)``; ``lse2 = lse * log2(e)``, and +inf on the
    padding rows and on fully masked rows (lse <= -1e29), whose
    probabilities are then exactly zero."""
    b, lq, h, _ = do.shape
    pad = _padded(lq) - lq
    dsum = (do.float() * o.float()).sum(-1).permute(0, 2, 1).reshape(b * h, lq)
    lse = lse.reshape(b * h, lq)
    lse2 = torch.where(lse > -1e29, lse * LOG2E, torch.full_like(lse, float("inf")))
    dsum = torch.nn.functional.pad(dsum, (0, pad), value=0.0)
    lse2 = torch.nn.functional.pad(lse2, (0, pad), value=float("inf"))
    return dsum.contiguous(), lse2.contiguous()


# -- CUDA kernels ------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The CUDA-core kernels (float32 forward, dq, dk/dv)."""
    lib = _build.load("flash_attention")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tfk8s_flash_fwd_simt.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.tfk8s_flash_bwd_dq_simt.argtypes = [P] * 8 + [I] * 6 + [P]
    lib.tfk8s_flash_bwd_dkv_simt.argtypes = [P] * 9 + [I] * 6 + [P]
    for fn in (lib.tfk8s_flash_fwd_simt, lib.tfk8s_flash_bwd_dq_simt,
               lib.tfk8s_flash_bwd_dkv_simt):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _lib_sm90() -> ctypes.CDLL:
    """The tensor-core kernels (bfloat16 forward, D pre-pass, dq, dk/dv)."""
    lib = _build.load("flash_attention_sm90")
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tfk8s_flash_fwd_wgmma.argtypes = [P] * 6 + [I] * 6 + [P]
    lib.tfk8s_flash_bwd_dsum.argtypes = [P] * 5 + [I] * 5 + [P]
    lib.tfk8s_flash_bwd_dq_wgmma.argtypes = [P] * 8 + [I] * 7 + [P]
    lib.tfk8s_flash_bwd_dkv_wgmma.argtypes = [P] * 9 + [I] * 7 + [P]
    for fn in (lib.tfk8s_flash_fwd_wgmma, lib.tfk8s_flash_bwd_dsum,
               lib.tfk8s_flash_bwd_dq_wgmma, lib.tfk8s_flash_bwd_dkv_wgmma):
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(q, k, v, mask, do=None, o=None, lse=None) -> Optional[torch.Tensor]:
    """Validate the kernels' inputs; returns the mask as contiguous uint8
    on q's device (or None)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes [b, l, h, d] tensors")
    b, lq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash kernels are built for head_dim in {HEAD_DIMS}, got {d}")
    if do is not None and (do.shape != q.shape or o.shape != q.shape):
        raise ValueError("do and o must have q's shape")
    if lse is not None and (lse.dtype != torch.float32 or lse.shape != (b, h, lq)):
        raise ValueError(f"lse must be float32 [b, h, lq], got {lse.dtype} {tuple(lse.shape)}")
    for t in (q, k, v, do, o, lse):
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t is not lse and t.dtype != q.dtype:
            raise TypeError(f"mixed dtypes {t.dtype} and {q.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash kernels take contiguous tensors")
        if q.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError("the tensor-core flash kernels take 16-byte aligned tensors (TMA)")
    if mask is None:
        return None
    if tuple(mask.shape) != (b, k.shape[1]):
        raise ValueError(f"mask must be [batch, lk] = {(b, k.shape[1])}, got {tuple(mask.shape)}")
    if mask.device != q.device:
        raise ValueError(f"mask on {mask.device}, tensors on {q.device}")
    return mask.to(torch.uint8).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def flash_fwd_cuda(q, k, v, mask=None, causal=False, save_lse=True):
    """Launch the forward kernel: ``(o, lse or None)``. bfloat16 takes the
    tensor-core kernel, float32 the CUDA-core one."""
    m8 = _check_cuda(q, k, v, mask)
    b, lq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device) if save_lse else None
    if o.numel() == 0:
        return o, lse
    tc = q.dtype == torch.bfloat16
    name = "flash_fwd_wgmma" if tc else "flash_fwd_simt"
    with torch.cuda.device(q.device):
        fn = _lib_sm90().tfk8s_flash_fwd_wgmma if tc else _lib().tfk8s_flash_fwd_simt
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(m8), o.data_ptr(), _ptr(lse),
                b, lq, k.shape[1], h, d, int(causal), _stream())
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, o, lse, mask=None, causal=False):
    """Launch dq. bfloat16 takes the D pre-pass and the tensor-core
    kernel, float32 the CUDA-core kernel."""
    m8 = _check_cuda(q, k, v, mask, do, o, lse)
    b, lq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        if k.numel() == 0 or q.numel() == 0:  # no query sees any key
            return torch.zeros_like(q)
        dsum, lse2 = flash_bwd_dsum_cuda(do, o, lse)
        return flash_bwd_dq_wgmma_cuda(q, k, v, do, dsum, lse2, mask, causal)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    with torch.cuda.device(q.device):
        rc = _lib().tfk8s_flash_bwd_dq_simt(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _ptr(m8), dq.data_ptr(),
            b, lq, k.shape[1], h, d, int(causal), _stream(),
        )
    _raise_on(rc, "flash_bwd_dq_simt")
    LAUNCHES["flash_bwd_dq_simt"] += 1
    return dq


def flash_bwd_dsum_cuda(do, o, lse):
    """Launch the backward pre-pass (bfloat16): ``(dsum, lse2)`` as
    ``flash_bwd_dsum_plain`` gives them."""
    b, lq, h, d = do.shape
    _check_cuda(do, do, do, None, do, o, lse)
    if do.dtype != torch.bfloat16:
        raise TypeError(f"the D pre-pass takes bfloat16, got {do.dtype}")
    lqp = _padded(lq)
    dsum = torch.empty((b * h, lqp), dtype=torch.float32, device=do.device)
    lse2 = torch.empty_like(dsum)
    with torch.cuda.device(do.device):
        rc = _lib_sm90().tfk8s_flash_bwd_dsum(
            do.data_ptr(), o.data_ptr(), lse.data_ptr(), dsum.data_ptr(), lse2.data_ptr(),
            b, lq, h, d, lqp, _stream(),
        )
    _raise_on(rc, "flash_bwd_dsum")
    LAUNCHES["flash_bwd_dsum"] += 1
    return dsum, lse2


def _check_tensor_core_bwd(name, q, k, v, do, dsum, lse2, mask):
    """Validate a tensor-core backward kernel's inputs, the pre-pass's
    ``(dsum, lse2)`` among them; returns the mask as for ``_check_cuda``."""
    m8 = _check_cuda(q, k, v, mask, do, do)
    b, lq, h, _ = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the tensor-core {name} kernel takes bfloat16, got {q.dtype}")
    lqp = _padded(lq)
    for t in (dsum, lse2):
        if (t.dtype != torch.float32 or t.shape != (b * h, lqp) or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"dsum and lse2 must be contiguous float32 {(b * h, lqp)} "
                             f"on {q.device}")
    return m8


def flash_bwd_dq_wgmma_cuda(q, k, v, do, dsum, lse2, mask=None, causal=False):
    """Launch the tensor-core dq kernel (bfloat16) on the pre-pass's
    ``(dsum, lse2)``."""
    m8 = _check_tensor_core_bwd("dq", q, k, v, do, dsum, lse2, mask)
    b, lq, h, d = q.shape
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    if k.numel() == 0:  # no key to see
        return dq.zero_()
    with torch.cuda.device(q.device):
        rc = _lib_sm90().tfk8s_flash_bwd_dq_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dsum.data_ptr(),
            lse2.data_ptr(), _ptr(m8), dq.data_ptr(),
            b, lq, k.shape[1], h, d, _padded(lq), int(causal), _stream(),
        )
    _raise_on(rc, "flash_bwd_dq_wgmma")
    LAUNCHES["flash_bwd_dq_wgmma"] += 1
    return dq


def flash_bwd_dkv_wgmma_cuda(q, k, v, do, dsum, lse2, mask=None, causal=False):
    """Launch the tensor-core dk/dv kernel (bfloat16) on the pre-pass's
    ``(dsum, lse2)``: ``(dk, dv)``."""
    m8 = _check_tensor_core_bwd("dk/dv", q, k, v, do, dsum, lse2, mask)
    b, lq, h, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    if q.numel() == 0:  # no query to be seen by
        return dk.zero_(), dv.zero_()
    with torch.cuda.device(q.device):
        rc = _lib_sm90().tfk8s_flash_bwd_dkv_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dsum.data_ptr(),
            lse2.data_ptr(), _ptr(m8), dk.data_ptr(), dv.data_ptr(),
            b, lq, k.shape[1], h, d, _padded(lq), int(causal), _stream(),
        )
    _raise_on(rc, "flash_bwd_dkv_wgmma")
    LAUNCHES["flash_bwd_dkv_wgmma"] += 1
    return dk, dv


def flash_bwd_dkv_cuda(q, k, v, do, o, lse, mask=None, causal=False):
    """Launch dk/dv: ``(dk, dv)``. bfloat16 takes the D pre-pass and the
    tensor-core kernel, float32 the CUDA-core kernel."""
    m8 = _check_cuda(q, k, v, mask, do, o, lse)
    b, lq, h, d = q.shape
    if q.dtype == torch.bfloat16:
        if k.numel() == 0 or q.numel() == 0:  # no query sees any key
            return torch.zeros_like(k), torch.zeros_like(v)
        dsum, lse2 = flash_bwd_dsum_cuda(do, o, lse)
        return flash_bwd_dkv_wgmma_cuda(q, k, v, do, dsum, lse2, mask, causal)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    with torch.cuda.device(q.device):
        rc = _lib().tfk8s_flash_bwd_dkv_simt(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o.data_ptr(),
            lse.data_ptr(), _ptr(m8), dk.data_ptr(), dv.data_ptr(),
            b, lq, k.shape[1], h, d, int(causal), _stream(),
        )
    _raise_on(rc, "flash_bwd_dkv_simt")
    LAUNCHES["flash_bwd_dkv_simt"] += 1
    return dk, dv


def flash_bwd_cuda(q, k, v, do, o, lse, mask=None, causal=False):
    """Launch the whole backward: ``(dq, dk, dv)``. bfloat16 runs the D
    pre-pass once and feeds it to the tensor-core dq and dk/dv kernels;
    float32 runs the CUDA-core dq and dk/dv kernels."""
    if q.dtype != torch.bfloat16:
        return (flash_bwd_dq_cuda(q, k, v, do, o, lse, mask, causal),
                *flash_bwd_dkv_cuda(q, k, v, do, o, lse, mask, causal))
    _check_cuda(q, k, v, mask, do, o, lse)
    if k.numel() == 0 or q.numel() == 0:  # no query sees any key
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dsum, lse2 = flash_bwd_dsum_cuda(do, o, lse)
    return (flash_bwd_dq_wgmma_cuda(q, k, v, do, dsum, lse2, mask, causal),
            *flash_bwd_dkv_wgmma_cuda(q, k, v, do, dsum, lse2, mask, causal))


# -- dispatch: the kernel on the card, the plain version on the CPU -----------


def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.is_cuda:
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"flash attention runs on cuda or cpu tensors, got {t.device}")


def flash_fwd(q, k, v, mask=None, causal=False, save_lse=True):
    return _route(q, flash_fwd_cuda, flash_fwd_plain)(q, k, v, mask, causal, save_lse)


def flash_bwd(q, k, v, do, o, lse, mask=None, causal=False):
    """The whole backward: ``(dq, dk, dv)``."""
    return _route(q, flash_bwd_cuda, flash_bwd_plain)(q, k, v, do, o, lse, mask, causal)


class FlashAttention(torch.autograd.Function):
    """Forward kernel, then the backward's kernels (the reference's
    ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal):
        # the logsumexp is a residual: save it only when a backward follows
        need_grad = any(ctx.needs_input_grad[:3])
        o, lse = flash_fwd(q, k, v, mask, causal, save_lse=need_grad)
        if need_grad:
            ctx.save_for_backward(q, k, v, o, lse, mask)
            ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, do.contiguous(), o, lse, mask, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # [b, lq, h, d], pre-scaled
    k: torch.Tensor,  # [b, lk, h, d]
    v: torch.Tensor,  # [b, lk, h, d]
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
) -> torch.Tensor:
    """Drop-in for ``models.transformer.dot_product_attention``. ``mask``
    is ``[batch, lk]`` key validity (True = attend); rows whose keys are
    ALL masked give zero output and zero grads (the plain attention gives
    a uniform average there)."""
    if mask is not None and mask.dim() != 2:
        raise NotImplementedError(
            "flash attention: only [batch, lk] key-validity masks are "
            f"supported, got shape {tuple(mask.shape)}"
        )
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(
            f"causal flash attention requires lq <= lk, got lq={q.shape[1]} "
            f"lk={k.shape[1]}"
        )
    return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), mask, causal)


def auto_flash_attn_fn(attention_impl: str, seq_len: int, device: torch.device):
    """The attention-impl policy: explicit ``"flash"`` always wins,
    ``"full"`` pins the plain ``dot_product_attention``, and ``"auto"``
    picks flash on the card once the sequence reaches
    FLASH_SEQ_THRESHOLD. Returns ``flash_attention`` or None (= plain
    attention). Unknown names raise: a typo must not silently change the
    attention."""
    if attention_impl == "flash":
        return flash_attention
    if attention_impl == "full":
        return None
    if attention_impl != "auto":
        raise ValueError(
            f"unknown attention_impl {attention_impl!r}; expected one of "
            "'auto', 'full', 'flash', 'ring', 'ulysses'"
        )
    if torch.device(device).type == "cuda" and seq_len >= FLASH_SEQ_THRESHOLD:
        return flash_attention
    return None


__all__ = [
    "FLASH_SEQ_THRESHOLD", "HEAD_DIMS", "KERNELS", "LAUNCHES", "SIMT_KERNELS",
    "TENSOR_CORE_KERNELS", "FlashAttention",
    "auto_flash_attn_fn", "flash_attention", "flash_bwd", "flash_fwd", "reset_launches",
]
