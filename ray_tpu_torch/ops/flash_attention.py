"""Flash attention for training (port of
``ray_tpu/ops/pallas/flash_attention.py``): the forward (K1) and the
backward (K2a, dq, and K2b, dk and dv: one kernel in bfloat16, two in
float32).

Layout contract, as the TPU kernels': q and dout (B, Hq, Sq, D), k and v
(B, Hkv, Skv, D), lse and delta (B, Hq, Sq) float32 with
``delta = rowsum(dout * out) - dlse``. Causal masking is top-left aligned
(row >= col). GQA reads kv head ``h // (Hq // Hkv)``.

On CUDA tensors :func:`flash_attention_fwd` and :func:`flash_attention_bwd`
launch the hand-written kernels of ``ray_tpu_torch/csrc/flash_attention.cu``
(in bfloat16 the forward ``flash_fwd_kernel`` and the backward
``flash_bwd_kernel``; in float32 ``flash_fwd_f32_kernel``,
``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``) and raise
on operands those kernels do not take; on CPU tensors they compute the
plain versions :func:`flash_attention_fwd_reference` (a copy of
``_fwd_xla``, ``ray_tpu/ops/attention.py:49``) and
:func:`flash_attention_bwd_reference` (the blockwise ``_flash_bwd_xla``,
``attention.py:113``, taking delta from the caller). Only kernel launches
are counted: ``flash_attention_fwd.launches`` and
``flash_attention_bwd.launches["bwd"]`` / ``["dq"]`` / ``["dkv"]``.
"""

from __future__ import annotations

import ctypes

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)


# ------------------------------------------------------------ plain versions

def _group(q, k) -> int:
    if q.dim() != 4 or k.dim() != 4 or q.shape[1] % k.shape[1]:
        raise ValueError(f"flash attention wants q (B,Hq,Sq,D) and k, v "
                         f"(B,Hkv,Skv,D) with Hq a multiple of Hkv; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    return q.shape[1] // k.shape[1]


def _repeat_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    return x if group == 1 else x.repeat_interleave(group, dim=1)


def flash_attention_fwd_reference(q, k, v, *, causal: bool, scale: float):
    """Fused full-matrix forward, f32 scores: returns (out in q's dtype,
    lse f32). A row with every column masked gets lse ``NEG_INF``."""
    group = _group(q, k)
    k, v = _repeat_kv(k, group), _repeat_kv(v, group)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        row = torch.arange(s.shape[-2], device=s.device)[:, None]
        col = torch.arange(s.shape[-1], device=s.device)[None, :]
        s = torch.where(row >= col, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp(min=NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", p / l.clamp(min=1e-30), v.float())
    lse = (m + torch.log(l.clamp(min=1e-30)))[..., 0]
    return out.to(q.dtype), lse


def _bwd_operands(q, k, v, lse, delta, dout):
    group = _group(q, k)
    return (q.float(), _repeat_kv(k, group).float(),
            _repeat_kv(v, group).float(), dout.float(), lse.float(),
            delta.float())


def bwd_dq_reference(q, k, v, lse, delta, dout, *, causal: bool,
                     scale: float, block: int = 512):
    """Pass 1 of the plain backward (the counterpart of K2a): walk kv
    blocks, accumulating dQ = scale · dS K in f32, one Sq x block tile of
    scores at a time."""
    qf, kf, vf, do, lse, delta = _bwd_operands(q, k, v, lse, delta, dout)
    sq, skv = q.shape[2], k.shape[2]
    blk = min(block, sq, skv)
    row = torch.arange(sq, device=q.device)
    dq = torch.zeros_like(qf)
    for c0 in range(0, skv, blk):
        kb, vb = kf[:, :, c0:c0 + blk], vf[:, :, c0:c0 + blk]
        col = c0 + torch.arange(kb.shape[2], device=q.device)
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
                      - lse[..., None])
        if causal:
            p = torch.where(row[:, None] >= col[None, :], p,
                            torch.zeros_like(p))
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bhqk,bhkd->bhqd", ds, kb) * scale
    return dq.to(q.dtype)


def bwd_dkv_reference(q, k, v, lse, delta, dout, *, causal: bool,
                      scale: float, block: int = 512):
    """Pass 2 of the plain backward (the counterpart of K2b): walk q
    blocks, accumulating dV = Pᵀ dO and dK = scale · dSᵀ Q in f32, then
    sum the GQA group."""
    qf, kf, vf, do, lse, delta = _bwd_operands(q, k, v, lse, delta, dout)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    blk = min(block, sq, skv)
    col = torch.arange(skv, device=q.device)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    for r0 in range(0, sq, blk):
        qb, dob = qf[:, :, r0:r0 + blk], do[:, :, r0:r0 + blk]
        row = r0 + torch.arange(qb.shape[2], device=q.device)
        p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qb, kf) * scale
                      - lse[:, :, r0:r0 + blk, None])
        if causal:
            p = torch.where(row[:, None] >= col[None, :], p,
                            torch.zeros_like(p))
        dv += torch.einsum("bhqk,bhqd->bhkd", p, dob)
        dp = torch.einsum("bhqd,bhkd->bhqk", dob, vf)
        ds = p * (dp - delta[:, :, r0:r0 + blk, None])
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qb) * scale
    if hq != hkv:
        dk = dk.reshape(b, hkv, hq // hkv, skv, d).sum(dim=2)
        dv = dv.reshape(b, hkv, hq // hkv, skv, d).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(q, k, v, lse, delta, dout, *, causal: bool,
                                  scale: float, block: int = 512):
    """Blockwise recompute-form backward in f32 (``_flash_bwd_xla`` with
    delta from the caller): returns (dq, dk, dv) in the input dtypes."""
    kw = dict(causal=causal, scale=scale, block=block)
    return (bwd_dq_reference(q, k, v, lse, delta, dout, **kw),
            *bwd_dkv_reference(q, k, v, lse, delta, dout, **kw))


# How far a kernel's result may lie from its plain version's, by the dtype
# of ``got``: row by row, ||got_r - want_r|| <= rtol * ||want_r|| + atol *
# rms_r, a row being the D values of one position of one head (each lse
# value is a row of its own) and rms_r the root mean square of the rows'
# norms. Each row is held to its own norm, so the late causal rows, far
# smaller than the first ones, are held to their own scale; ``atol`` only
# covers rows whose exact value is about 0 (dq of causal row 0). A bound
# per element would need a large atol in bf16, for elements near 0 in rows
# of large norm, and would then pass a late row wrong by its own size.
# float32: the same arithmetic
# summed in another order. bfloat16: the kernels round P (forward) and P,
# dS (backward) to bf16 for the tensor cores, relative error 2^-9 per
# term, where the plain version keeps f32, and both round the result to
# bf16. lse is float32 in both instantiations.
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-3)}


def mismatch(got: torch.Tensor, want: torch.Tensor) -> dict:
    """Compare a kernel's result with its plain version under
    :data:`TOLERANCE`: ``excess`` is the largest row error over its
    allowance (at most 1 within tolerance)."""
    rtol, atol = TOLERANCE[got.dtype]
    g, w = got.double(), want.double()
    if g.dim() < 4:                                   # lse: one value a row
        g, w = g[..., None], w[..., None]
    err = (g - w).norm(dim=-1)
    norm = w.norm(dim=-1)
    rms = norm.square().mean().sqrt()
    excess = (err / (rtol * norm + atol * rms).clamp(min=1e-30)).max().item()
    return {"max_abs_err": (g - w).abs().max().item(),
            "rel_norm_err": (err.norm() / norm.norm().clamp(min=1e-30)).item(),
            "excess": excess, "ok": excess <= 1.0}


# ------------------------------------------------------------ kernels

def check_operands(q, k, v, dout=None, rows=()) -> int:
    """Validate operands of a flash-attention kernel launch: q and dout
    (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), and the f32 (B, Hq, Sq) row
    vectors ``rows``; returns the kernel's dtype code."""
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    _group(q, k)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    B, Hq, Sq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("q and k/v disagree on batch or head_dim")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if Sq == 0 or k.shape[2] == 0:
        raise ValueError("flash attention needs Sq >= 1 and Skv >= 1")
    tensors = (q, k, v) + (() if dout is None else (dout,)) + tuple(rows)
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"operands on {t.device} and {q.device}")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous "
                             "operands")
        if t.data_ptr() % 16:
            raise ValueError("flash attention operand storage is not "
                             "16-byte aligned")
    for t in (k, v) + (() if dout is None else (dout,)):
        if t.dtype != q.dtype:
            raise TypeError(f"k/v/dout dtype {t.dtype} != q dtype {q.dtype}")
    if dout is not None and dout.shape != q.shape:
        raise ValueError("dout must match q in shape")
    for t in rows:
        if t.dtype != torch.float32 or t.shape != (B, Hq, Sq):
            raise ValueError(f"lse/delta must be float32 {(B, Hq, Sq)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    return _DTYPES[q.dtype]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE = [_I] * 6                                  # B, Hq, Hkv, Sq, Skv, D
# The parameters of each extern "C" launch function of flash_attention.cu,
# in order: tensors, shape, scale, causal, (dtype,) stream.
ARGTYPES = {
    "flash_fwd_launch": [_P] * 5 + _SHAPE + [_F, _I, _I, _P],
    "flash_bwd_dq_launch": [_P] * 7 + _SHAPE + [_F, _I, _I, _P],
    "flash_bwd_dkv_launch": [_P] * 8 + _SHAPE + [_F, _I, _I, _P],
    "flash_bwd_launch": [_P] * 9 + _SHAPE + [_F, _I, _P],
}


def _fn(name: str):
    fn = getattr(_build.load("flash_attention"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ARGTYPES[name]
    return fn


def _raise_on_error(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {rc}")


def _device_kind(q) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention: unsupported device {q.device}")
    return q.device.type


def flash_attention_fwd(q, k, v, *, causal: bool, scale: float):
    """q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) → (out (B,Hq,Sq,D) in q.dtype,
    lse (B,Hq,Sq) f32)."""
    if _device_kind(q) == "cpu":
        return flash_attention_fwd_reference(q, k, v, causal=causal,
                                             scale=scale)
    dtype = check_operands(q, k, v)
    B, Hq, Sq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, Sq, dtype=torch.float32, device=q.device)
    rc = _fn("flash_fwd_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, Hq, k.shape[1], Sq, k.shape[2], D, float(scale),
        int(causal), dtype, _stream(q))
    _raise_on_error(rc, "flash_fwd_f32_kernel" if dtype == 0
                    else "flash_fwd_kernel")
    flash_attention_fwd.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, lse, delta, dout, *, causal: bool,
                        scale: float, block: int = 512):
    """Recompute-form backward → (dq, dk, dv) in the input dtypes and
    shapes. ``block`` tiles the plain version only; the kernels pick their
    own tiles."""
    if _device_kind(q) == "cpu":
        return flash_attention_bwd_reference(q, k, v, lse, delta, dout,
                                             causal=causal, scale=scale,
                                             block=block)
    check_operands(q, k, v, dout, (lse, delta))
    if q.dtype == torch.bfloat16:
        return bwd_fused(q, k, v, lse, delta, dout, causal=causal,
                         scale=scale)
    dq = bwd_dq(q, k, v, lse, delta, dout, causal=causal, scale=scale)
    dk, dv = bwd_dkv(q, k, v, lse, delta, dout, causal=causal, scale=scale)
    return dq, dk, dv


def _shape_args(q, k):
    B, Hq, Sq, D = q.shape
    return B, Hq, k.shape[1], Sq, k.shape[2], D


def _stream(q) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def bwd_fused(q, k, v, lse, delta, dout, *, causal: bool, scale: float):
    """Launch ``flash_bwd_kernel`` on checked bfloat16 CUDA operands →
    (dq, dk, dv). dq is summed across kv tiles in a zeroed float32
    workspace and cast to bfloat16 here."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_bwd_kernel takes bfloat16, got {q.dtype}")
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _fn("flash_bwd_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), *_shape_args(q, k), float(scale), int(causal),
        _stream(q))
    _raise_on_error(rc, "flash_bwd_kernel")
    flash_attention_bwd.launches["bwd"] += 1
    return dq_acc.to(q.dtype), dk, dv


def _f32_only(q, kernel: str) -> None:
    if q.dtype != torch.float32:
        raise TypeError(f"{kernel} takes float32 (bfloat16 goes to "
                        f"flash_bwd_kernel), got {q.dtype}")


def bwd_dq(q, k, v, lse, delta, dout, *, causal: bool, scale: float):
    """Launch ``flash_bwd_dq_kernel`` on checked float32 CUDA operands →
    dq."""
    _f32_only(q, "flash_bwd_dq_kernel")
    dq = torch.empty_like(q)
    rc = _fn("flash_bwd_dq_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *_shape_args(q, k),
        float(scale), int(causal), _DTYPES[q.dtype], _stream(q))
    _raise_on_error(rc, "flash_bwd_dq_kernel")
    flash_attention_bwd.launches["dq"] += 1
    return dq


def bwd_dkv(q, k, v, lse, delta, dout, *, causal: bool, scale: float):
    """Launch ``flash_bwd_dkv_kernel`` on checked float32 CUDA operands →
    (dk, dv)."""
    _f32_only(q, "flash_bwd_dkv_kernel")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _fn("flash_bwd_dkv_launch")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_shape_args(q, k), float(scale), int(causal), _DTYPES[q.dtype],
        _stream(q))
    _raise_on_error(rc, "flash_bwd_dkv_kernel")
    flash_attention_bwd.launches["dkv"] += 1
    return dk, dv


flash_attention_fwd.launches = 0
flash_attention_bwd.launches = {"bwd": 0, "dq": 0, "dkv": 0}
