"""Stage-1/2 feature matching: similarity volume and template selection.

Counterpart of picopose_tpu/ops/matching.py, with the scoring of
``match_templates`` on a shared bank done by a CUDA kernel on the card
(``kernels/csrc/matching.cu``, replacing
picopose_tpu/ops/pallas/matching.py::match_scores_pallas) and by its plain
version on the CPU.  The kernel is bound by operations: at B = 16 queries
against N = 162 bf16 views (S = 256, C = 1024) it does 348 GFLOP of
products over 93 MB of input.  The TPU kernel's whole (S, S) fp32 block
(256 KB) does not fit a Hopper block, so the kernel computes sim in blocks
of 128 query rows x 256 view rows (bf16: wgmma from a TMA-fed ring, the
block in registers; fp32: the CUDA cores) and keeps only row/column
maxima and sim[:,0], sim[0,:] per (query, view).

The serving modes of picopose_tpu/ops/matching.py:116-143 carry over:
PICOPOSE_MATCH_INT8=1 scores int8 operands (the kernel's s8 wgmma branch,
counted as ``match_scores_int8``), PICOPOSE_MATCH_FP32=1 keeps fp32
operands on a bf16 bank.

Two reference quirks are kept on purpose:
  * the similarity volume's query-spatial unflattening is TRANSPOSED: the
    volume at spatial (h, w) holds query patch (row=w, col=h);
  * the matching score multiplies a query-indexed mask with template-
    indexed argmax-validity terms at the same index i (aligned-index
    product).
"""

from __future__ import annotations

import os

import torch

from picopose_tpu_torch import kernels
from picopose_tpu_torch.ops.resize import resize_nearest


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """F.normalize semantics: x / max(||x||, eps)."""
    n = torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return x / torch.clamp(n, min=eps)


def _mask_to_grid(mask: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """(B, Hm, Wm) crop mask -> (B, h, w) by nearest downsampling."""
    return resize_nearest(mask, hw)


def feature_similarity_volume(
    tem_feat: torch.Tensor, query_feat: torch.Tensor, tem_mask: torch.Tensor
) -> torch.Tensor:
    """Masked cosine-similarity volume between one template and the query.

    tem_feat, query_feat: (B, h, w, C); tem_mask: (B, Hm, Wm).  Returns
    (B, h, w, h*w) = relu(cos(query[t], tem[s]) * tem_mask[s]); channel s is
    the template patch (row-major), spatial (h, w) the query patch
    (row=w, col=h).
    """
    B, h, w, C = tem_feat.shape
    q = l2_normalize(query_feat).reshape(B, h * w, C)
    t = l2_normalize(tem_feat).reshape(B, h * w, C)
    m = _mask_to_grid(tem_mask, (h, w)).reshape(B, 1, h * w).to(q.dtype)
    sim = torch.matmul(q, t.transpose(1, 2)) * m  # (B, t = query, s = template)
    sim = torch.clamp(sim, min=0.0)
    # transposed unflattening of the query index: t == w*h_dim + h
    return sim.reshape(B, w, h, h * w).transpose(1, 2)


INT8_SCALE = 127.0
# the rescale of the int8 products, 1 / 127^2 rounded once to fp32 (as a
# Python float it holds that fp32 value exactly, so x * INT8_INV_SQ on an
# fp32 tensor is the fp32 product)
INT8_INV_SQ = torch.tensor(1.0 / (INT8_SCALE * INT8_SCALE), dtype=torch.float32).item()
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}  # the C entry's dtype code


def quantize_int8(x: torch.Tensor) -> torch.Tensor:
    """Normalised fp32 features -> int8 at the symmetric scale 127."""
    return torch.clamp(torch.round(x * INT8_SCALE), -127, 127).to(torch.int8)


def match_mode_from_env() -> str | None:
    """The serving mode the environment asks for, as the JAX package reads
    it (picopose_tpu/ops/matching.py:116-143): "int8" for
    PICOPOSE_MATCH_INT8=1, else "fp32" for PICOPOSE_MATCH_FP32=1, else None
    (operands in the bank's dtype)."""
    if os.environ.get("PICOPOSE_MATCH_INT8", "0") == "1":
        return "int8"
    if os.environ.get("PICOPOSE_MATCH_FP32", "0") == "1":
        return "fp32"
    return None


def _sim(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(B, S, C) x (n, S, C) -> (B, n, S, S) fp32 sims; int8 operands as
    exact integer sums (fp64 products of the int8 values), converted to
    fp32 and rescaled by fp32(1 / 127^2), as the TPU kernel does."""
    if q.dtype == torch.int8:
        exact = torch.einsum("bsc,ntc->bnst", q.double(), t.double())
        return exact.float() * INT8_INV_SQ
    return torch.einsum("bsc,ntc->bnst", q.float(), t.float())


def match_scores_plain(
    q_norm: torch.Tensor, q_mask: torch.Tensor, t_norm: torch.Tensor
) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch ops: (B, S, C), (B, S), (N, S, C)
    -> (B, N) scores, 8 views at a time (the (B, 8, S, S) fp32 block is
    34 MB at B = 16, S = 256)."""
    B, S, _ = q_norm.shape
    qm = q_mask.float()[:, None, :, None]  # rows of sim are query patches
    qv = (q_mask > 0)[:, None, :]
    out = []
    for s0 in range(0, t_norm.shape[0], 8):
        sim = _sim(q_norm, t_norm[s0 : s0 + 8]) * qm
        rowmax = sim.amax(dim=3)
        t_valid = sim[..., 0] < rowmax
        colmax = sim.amax(dim=2)
        s_valid = sim[:, :, 0, :] < colmax
        w = (qv & t_valid & s_valid).float()
        count = w.sum(-1)
        total = (rowmax * w).sum(-1)
        out.append(torch.where(count > 0, total / S, torch.zeros_like(total)))
    return torch.cat(out, dim=1)


def match_scores_cuda(
    q_norm: torch.Tensor, q_mask: torch.Tensor, t_norm: torch.Tensor
) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, S, C) and t (N, S, C) both bf16, both
    fp32 or both int8 (counted as ``match_scores_int8``), q_mask (B, S); S
    and C multiples of 16."""
    if not (q_norm.is_cuda and q_mask.is_cuda and t_norm.is_cuda):
        raise ValueError("match_scores_cuda takes CUDA tensors")
    B, S, C = q_norm.shape
    N = t_norm.shape[0]
    if t_norm.shape[1:] != (S, C) or q_mask.shape != (B, S):
        raise ValueError("shapes must be q (B, S, C), q_mask (B, S), t (N, S, C)")
    if q_norm.dtype != t_norm.dtype or q_norm.dtype not in DTYPE_CODES:
        raise TypeError("match kernel takes q and t both bf16, both fp32 or both int8")
    if S % 16 or C % 16:
        raise ValueError(f"match kernel takes S and C multiples of 16, got {S}, {C}")
    q_norm, t_norm = kernels.contiguous_aligned(q_norm), kernels.contiguous_aligned(t_norm)
    q_mask = q_mask.to(torch.float32).contiguous()
    out = torch.empty((B, N), dtype=torch.float32, device=q_norm.device)
    if out.numel() == 0:
        return out
    name = "match_scores_int8" if q_norm.dtype == torch.int8 else "match_scores"
    with kernels.on_device_of(q_norm):
        kernels.launch(
            name, q_norm.data_ptr(), q_mask.data_ptr(), t_norm.data_ptr(),
            out.data_ptr(), B, N, S, C, DTYPE_CODES[q_norm.dtype],
            kernels.stream_of(q_norm),
        )
    return out


def match_scores(
    q_norm: torch.Tensor, q_mask: torch.Tensor, t_norm: torch.Tensor
) -> torch.Tensor:
    """(B, N) matching scores: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if q_norm.device.type == "cpu":
        return match_scores_plain(q_norm, q_mask, t_norm)
    return match_scores_cuda(q_norm, q_mask, t_norm)


def top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (lax.top_k order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def match_templates(
    tem_feats: torch.Tensor,
    query_feat: torch.Tensor,
    query_mask: torch.Tensor,
    topk: int = 5,
    mode: str | None = "env",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score every view of a shared (N, h, w, C) bank against each query;
    return top-k (scores, ids), both (B, topk).

    Per view: sim[t, s] = cos(query[t], tem[s]) * query_mask[t]; the score
    is sum_t max_s sim[t, s] * valid[t] / (h*w), valid combining the query
    mask with the argmax-nonzero consistency terms.  Features are
    normalised in fp32.  The operands, as the JAX package's kernel path
    picks them: by default those of the bank's dtype (a bf16 bank rounds
    the normalised operands to bf16); ``mode="fp32"`` keeps fp32 operands
    on a bf16 bank; ``mode="int8"`` quantises the fp32 normalised q and t
    to int8 at scale 127, whatever the bank's dtype.  ``mode="env"`` (the
    default) reads the serving mode from PICOPOSE_MATCH_INT8 /
    PICOPOSE_MATCH_FP32 (``match_mode_from_env``).
    """
    if tem_feats.ndim != 4:
        raise ValueError("match_templates takes a shared (N, h, w, C) bank")
    if mode == "env":
        mode = match_mode_from_env()
    if mode not in (None, "int8", "fp32"):
        raise ValueError(f"unknown matching mode {mode!r}")
    N, h, w, C = tem_feats.shape
    B, S = query_feat.shape[0], h * w
    q = l2_normalize(query_feat.float()).reshape(B, S, C)
    qm = _mask_to_grid(query_mask, (h, w)).reshape(B, S).float()
    t = l2_normalize(tem_feats.float()).reshape(N, S, C)
    if mode == "int8":
        q, t = quantize_int8(q), quantize_int8(t)
    elif mode is None and tem_feats.dtype == torch.bfloat16:
        q, t = q.to(torch.bfloat16), t.to(torch.bfloat16)
    return top_k(match_scores(q, qm, t), topk)
