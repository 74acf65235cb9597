"""Vision Transformer backbone (counterpart of byol_tpu/models/vit.py).

Same module names, fields and wiring as the flax ViT, so a converted flax
parameter tree loads with ``load_state_dict(strict=True)``:

- patch embedding as a strided VALID conv; the public input stays NHWC, and
  patch tokens are flattened row-major over (h, w);
- the cls token is prepended before the position embedding is added;
- pre-LN blocks, LayerNorm eps 1e-6 with fp32 statistics under bf16;
- the tanh approximation of GELU (flax ``nn.gelu``'s default);
- qkv split as ``reshape(b, s, 3, heads, head_dim)``;
- attention behind :func:`byol_tpu_torch.ops.attention.get_attention_fn`
  (``dense``, ``flash`` for inference, ``ring`` over the sequence axis);
- each encoder block's output tagged ``block_out`` and each block run
  under the remat policy (core/remat.py::wrap_block) that ``remat`` and
  ``remat_policy`` resolve to, as the flax ViT wraps its block class;
  ``remat_policy`` is an attribute, so one built net can switch it
  (core/remat.py::set_remat_policy).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from byol_tpu_torch.core import remat as remat_lib
from byol_tpu_torch.models.layers import Conv, Dense, LayerNorm
from byol_tpu_torch.ops.attention import get_attention_fn


class MlpBlock(nn.Module):
    def __init__(self, dim: int, hidden_dim: int,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.fc1 = Dense(dim, hidden_dim, dtype)
        self.fc2 = Dense(hidden_dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "dense") -> None:
        super().__init__()
        if dim % num_heads:
            raise ValueError(f"width {dim} not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.attn_fn = get_attention_fn(attn_impl)
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        qkv = self.qkv(x).reshape(b, s, 3, self.num_heads,
                                  d // self.num_heads)
        # (B, S, H, D) views -> (B, H, S, D) views: no copy before the kernel
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        out = self.attn_fn(q, k, v)
        return self.proj(out.transpose(1, 2).reshape(b, s, d))


class EncoderBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32,
                 attn_impl: str = "dense") -> None:
        super().__init__()
        self.ln1 = LayerNorm(dim, dtype)
        self.attn = SelfAttention(dim, num_heads, dtype, attn_impl)
        self.ln2 = LayerNorm(dim, dtype)
        self.mlp = MlpBlock(dim, mlp_ratio * dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return remat_lib.tag_block_out(x + self.mlp(self.ln2(x)))


class ViT(nn.Module):
    """Feature extractor: (B, H, W, C) -> (B, width)."""

    def __init__(self, width: int = 768, depth: int = 12, num_heads: int = 12,
                 patch_size: int = 16, mlp_ratio: int = 4,
                 dtype: torch.dtype = torch.float32, pooling: str = "cls",
                 attn_impl: str = "dense", remat: bool = False,
                 remat_policy: str = "none", *, image_size: int = 224,
                 in_channels: int = 3) -> None:
        super().__init__()
        self.remat_policy = remat_lib.resolve_policy_name(remat,
                                                          remat_policy)
        if pooling not in ("cls", "gap"):
            raise ValueError(f"unknown pooling {pooling!r}")
        if image_size % patch_size:
            raise ValueError(f"image size {image_size} not divisible by patch "
                             f"size {patch_size}")
        self.width, self.depth, self.num_heads = width, depth, num_heads
        self.patch_size, self.dtype, self.pooling = patch_size, dtype, pooling
        self.attn_impl = attn_impl
        self.patch_embed = Conv(in_channels, width, patch_size, patch_size,
                                dtype)
        seq = (image_size // patch_size) ** 2 + (pooling == "cls")
        if pooling == "cls":
            self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embedding = nn.Parameter(torch.empty(1, seq, width))
        for i in range(depth):
            self.add_module(f"block{i}", EncoderBlock(
                width, num_heads, mlp_ratio, dtype, attn_impl))
        self.ln_final = LayerNorm(width, dtype)

    @property
    def feature_dim(self) -> int:
        return self.width

    @torch.no_grad()
    def init_own_params(self, generator: torch.Generator) -> None:
        if self.pooling == "cls":
            self.cls_token.zero_()
        nn.init.normal_(self.pos_embedding, std=0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        if h % self.patch_size or w % self.patch_size:
            raise ValueError(f"image size {(h, w)} not divisible by patch "
                             f"size {self.patch_size}")
        dt = self.dtype
        x = self.patch_embed(x.to(dt).permute(0, 3, 1, 2))  # NHWC -> NCHW
        x = x.flatten(2).transpose(1, 2)            # (B, S, D), row-major h, w
        if self.pooling == "cls":
            cls = self.cls_token.to(dt).expand(b, 1, self.width)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embedding.to(dt)
        for i in range(self.depth):
            x = remat_lib.wrap_block(getattr(self, f"block{i}"),
                                     self.remat_policy)(x)
        x = self.ln_final(x)
        feat = x[:, 0] if self.pooling == "cls" else x.mean(dim=1)
        return feat.to(dt)
