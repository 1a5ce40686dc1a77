"""Llama-class causal decoder: the local chat LLM.

Counterpart of ``ragmeup_tpu/models/decoder.py`` for the dense-cache
generate path: RMSNorm → GQA attention with RoPE (llama3/linear frequency
scaling) → SwiGLU, weight-only int8 or packed-int4 projections
(``QuantDense``), a KV cache of shape (b, cache_len, nkv, hd) updated in
place, prefill through the causal flash kernel and decode through a grouped
einsum with the additive mask. ``LocalLLM.generate`` samples at T > 0 (an
explicit ``torch.Generator``) and decodes greedily at T = 0, by default
in a loop whose sampling state stays on the device (``fused``) and, at
T = 0, speculatively (``generate_speculative``: 2-gram prompt-lookup
drafts verified 8 tokens a forward against the dense cache; the host
reads each verify forward's greedy ids once and writes the cache at a
host offset, so there is one sync a forward). ``attention_forward`` and
``qk_forward`` capture attention for provenance.

The Llama-layout families of the JAX package are config branches
(``LlamaConfig``): Qwen2's q/k/v biases, Mistral's sliding window and
explicit head_dim, Phi-3's packed projections (split at load, or kept
whole with ``fused_projections``), Gemma's offset norms, embedding scale
and gelu MLP, Qwen3's per-head q/k norms, Gemma-2's norms around each
sublayer, logit softcaps, query scale and per-layer windows.

Parameters keep the JAX package's names and layouts (kernels are
``(in, out)``; int8 kernels ``kernel_q (in, out)`` with ``scale (out,)``;
int4 kernels ``kernel_p (in/2, out)`` with ``gscale (in/group, out)``), so
``models/convert.py`` loads flax trees as they are. With ``paged_caches``
the model attends a paged KV pool instead (``ops/paged_attention.py``): one
token per sequence (batched decode) or a chunk per sequence (chunked
prefill), written into the pool in place; ``pipeline/serving.py`` drives
it. With ``num_experts`` > 0 the MLP is a top-k routed sparse MoE
(``LlamaMoeMlp``, Mixtral / Qwen3-MoE class) over stacked int8, packed int4
or float experts (``ops/moe_matmul.py``).

Under a mesh whose model axis has D > 1 shards (``LocalLLM(mesh=...)``),
``ShardedLlamaModel`` drives D ``LlamaModel``s, one a shard, each built on
its own device with its local widths (``ModelShard``): Megatron tensor
parallelism (q/k/v and gate/up column-parallel on replicated input; o_proj
and down_proj row-parallel, their partial products summed by ``psum``),
the vocabulary sharded (a masked embedding lookup summed by ``psum``, the
head's logits gathered), the KV caches and page pools held per shard over
kv heads, the experts of a sparse MoE sharded over the axis (the
expert-parallel decode gather, or the all-experts einsum on the local
experts, combined by ``psum``), and with a corpus axis as well the ring
prefill over the corpus devices of each model shard. The residual stream
is replicated: each shard runs the layer on its own copy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ragmeup_tpu_torch.devices import resolve_device
from ragmeup_tpu_torch.models.layers import RMSNorm
from ragmeup_tpu_torch.ops.attention import (flash_attention, flash_attention_gqa,
                                             ring_attention)
from ragmeup_tpu_torch.ops.moe_matmul import (GATHER_MAX_SLOTS, dequant_int4_stack,
                                              grouped_int4_viable, moe_gather_matmul,
                                              moe_gather_matmul_int4,
                                              moe_grouped_matmul,
                                              moe_grouped_matmul_int4)
from ragmeup_tpu_torch.ops.paged_attention import (paged_attention,
                                                   paged_attention_chunk,
                                                   paged_update_chunk,
                                                   paged_update_token)
from ragmeup_tpu_torch.ops.quant_matmul import (INT4_TILE_N, MAX_ROWS,
                                                int4_group_for, int4_matmul,
                                                int4_tiling, int8_matmul,
                                                quantize_int4_groupwise,
                                                unpack_int4)
from ragmeup_tpu_torch.ops.topk import divide_exactly, rank_topk
from ragmeup_tpu_torch.parallel.mesh import (LOGICAL_RULES, all_gather, canonical,
                                             local_size, psum, replicate,
                                             vocab_sharded)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
QUANTIZATIONS = ("none", "int8", "int4")
FLASH_BLOCK = 128  # prefill takes the flash kernel when s and kv_len are multiples
# the serving LLM's rules: the JAX package's, with the vocabulary over 'model'
TP_RULES = vocab_sharded(LOGICAL_RULES)
HEAD_STRIP_BYTES = 1 << 28  # the int8 head's f32 weights dequantized at a time


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128256
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 500000.0
    max_seq_len: int = 8192
    rms_eps: float = 1e-5
    dtype: str = "bfloat16"
    quantization: str = "none"  # none | int8 | int4
    # int8 lm_head (lm_head_q + per-vocab lm_head_scale; untied heads only)
    head_quantization: str = "none"  # none | int8
    # int4 scale group along the input dim (0 = int4_tiling's 128-class);
    # the k-tile (512) takes the output-scaled kernel route
    int4_group: int = 0
    # W4A8: int8 activations against the int4 weights; needs
    # int4_group == 512 (hf_loader.select_kernels sets it)
    int4_w4a8: bool = False
    tie_embeddings: bool = True  # Llama-3.1-8B uses an untied lm_head
    # Q/K/V as one projection (qkv_proj) and gate/up as one (gate_up_proj):
    # column-concatenated kernels, the same numbers
    fused_projections: bool = False
    # the int8 decode kernel for QuantDense with at most 8 rows
    quant_kernel: bool = False
    # the causal flash kernel for prefill
    use_flash: bool = False
    # Qwen2-class f32 biases on the q/k/v projections
    qkv_bias: bool = False
    # Mistral-class sliding window: the query at position p attends keys in
    # (p - window, p]; 0 = full causal
    sliding_window: int = 0
    # an explicit per-head width (HF "head_dim"); 0 = hidden_size / num_heads
    head_dim_override: int = 0
    # the MLP's gate activation: silu | gelu_tanh (Gemma) | gelu (exact erf)
    act_fn: str = "silu"
    # RMSNorm multiplies by (scale + norm_offset): Gemma stores the scale less 1
    norm_offset: float = 0.0
    # Gemma: the embeddings times sqrt(hidden_size), rounded to the model dtype
    embed_scale: bool = False
    # Qwen3-class per-head RMSNorm on q and k over head_dim, before rope
    qk_norm: bool = False
    # Gemma-2: cap * tanh(x / cap) on the scaled attention logits, before the
    # mask (0 = off; the flash prefill is then not taken) ...
    attn_softcap: float = 0.0
    # ... and on the f32 logits after the head
    final_softcap: float = 0.0
    # the attention scale; 0 = 1 / sqrt(head_dim) (Gemma-2:
    # query_pre_attn_scalar ** -0.5)
    query_scale: float = 0.0
    # Gemma-2's block: post_attn_norm on the attention output, pre_ffw_norm
    # and post_ffw_norm around the MLP
    post_norms: bool = False
    # per-layer windows (Gemma-2's alternating layers); empty = every layer
    # takes sliding_window; an entry 0 = full attention
    layer_windows: tuple = ()
    rope_scaling_type: str = "none"  # none | llama3 | linear
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position: int = 8192
    # Sparse MoE (Mixtral / Qwen3-MoE family): num_experts > 0 swaps the
    # dense MLP for top-k routed experts (LlamaMoeMlp) over stacked (E, h, f)
    # expert tensors
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0  # 0 = intermediate_size
    # renormalize the kept top-k routing weights to sum 1 (Mixtral always
    # does; Qwen-MoE gates it behind config norm_topk_prob)
    norm_topk_prob: bool = True
    # per-layer MoE flags (Qwen3-MoE keeps some layers dense); empty = every
    # layer MoE when num_experts > 0
    moe_layers: tuple = ()
    # "auto": the all-experts einsum past the batched-decode gates; "on":
    # grouped matmuls (ops/moe_matmul.moe_grouped_matmul) for every t
    moe_grouped: str = "auto"

    def __post_init__(self):
        if self.quantization not in QUANTIZATIONS:
            raise ValueError(f"quantization={self.quantization!r}: expected "
                             f"one of {QUANTIZATIONS}")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        base = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                    num_kv_heads=2, intermediate_size=128, max_seq_len=256,
                    rope_theta=10000.0)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def llama31_8b(**kw) -> "LlamaConfig":
        """Llama-3.1-8B's shape (scripts/make_synthetic_8b.py): the defaults
        above with int8 weights, an untied lm_head and llama3 rope scaling."""
        base = dict(quantization="int8", tie_embeddings=False,
                    rope_scaling_type="llama3", rope_scaling_factor=8.0,
                    rope_scaling_low_freq_factor=1.0,
                    rope_scaling_high_freq_factor=4.0,
                    rope_scaling_original_max_position=8192)
        base.update(kw)
        return LlamaConfig(**base)

    @staticmethod
    def mixtral_8x7b(**kw) -> "LlamaConfig":
        """mistralai/Mixtral-8x7B-v0.1's config.json as the JAX package's
        ``llama_config_from_hf`` maps ``model_type: mixtral``: 8 experts,
        top-2 renormalized, rope theta 1e6, 32768 positions, an untied
        lm_head, int8 weights (``quantization="int4"``: packed int4)."""
        base = dict(vocab_size=32000, hidden_size=4096, num_layers=32,
                    num_heads=32, num_kv_heads=8, intermediate_size=14336,
                    num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
                    rope_theta=1e6, rms_eps=1e-5, max_seq_len=32768,
                    tie_embeddings=False, quantization="int8")
        base.update(kw)
        return LlamaConfig(**base)

    def is_moe_layer(self, i: int) -> bool:
        return bool(self.num_experts) and (
            bool(self.moe_layers[i]) if self.moe_layers else True)

    def layer_window(self, i: int) -> int:
        """Layer i's sliding window (0 = full attention)."""
        return self.layer_windows[i] if self.layer_windows else self.sliding_window


def activation(name: str):
    """The MLP's gate activation by ``LlamaConfig.act_fn``."""
    if name == "silu":
        return F.silu
    if name == "gelu_tanh":  # Gemma's gelu_pytorch_tanh
        return lambda g: F.gelu(g, approximate="tanh")
    if name == "gelu":
        return lambda g: F.gelu(g, approximate="none")
    raise ValueError(f"unsupported act_fn {name!r}")


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """One shard of the mesh's model axis: its ``index`` of ``count``, and
    the devices of the corpus axis that ring its prefill (more than one:
    the sequence-parallel prefill of ``LlamaAttention``)."""
    index: int
    count: int
    ring_devices: tuple = ()

    def size(self, n: int, name: str) -> int:
        """A dim of logical ``name`` and global size n on this shard."""
        return local_size(n, name, self.count, TP_RULES)


def _local(shard: Optional[ModelShard], n: int, name: str) -> int:
    return n if shard is None else shard.size(n, name)


def int4_tiles(k: int, group: int = 0) -> Tuple[int, int]:
    """(packing tile, scale group) of an int4 weight with input dim k:
    ``int4_tiling``'s, the group walked down from ``group`` when it is set
    (``LlamaConfig.int4_group``)."""
    tile_k, auto = int4_tiling(k)
    return tile_k, int4_group_for(tile_k, group) if group else auto


def scale_inv_freq_llama3(inv: np.ndarray, factor: float,
                          low_freq_factor: float, high_freq_factor: float,
                          original_max_position: int) -> np.ndarray:
    """Llama-3.1 rope scaling (HF _compute_llama3_parameters): long
    wavelengths divided by `factor`, short ones untouched, smooth
    interpolation between the two wavelength thresholds."""
    low_wavelen = original_max_position / low_freq_factor
    high_wavelen = original_max_position / high_freq_factor
    wavelen = 2.0 * np.pi / inv
    smooth = (original_max_position / wavelen - low_freq_factor) / \
        max(high_freq_factor - low_freq_factor, 1e-9)
    interp = (1.0 - smooth) * inv / factor + smooth * inv
    out = np.where(wavelen > low_wavelen, inv / factor, inv)
    mid = (wavelen <= low_wavelen) & (wavelen >= high_wavelen)
    return np.where(mid, interp, out)


def rope_inv_freq(head_dim: int, theta: float,
                  cfg: Optional[LlamaConfig] = None) -> np.ndarray:
    """(hd/2,) inverse frequencies with any configured scaling applied."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim))
    if cfg is not None and cfg.rope_scaling_type == "llama3":
        inv = scale_inv_freq_llama3(
            inv, cfg.rope_scaling_factor, cfg.rope_scaling_low_freq_factor,
            cfg.rope_scaling_high_freq_factor,
            cfg.rope_scaling_original_max_position)
    elif cfg is not None and cfg.rope_scaling_type == "linear":
        inv = inv / cfg.rope_scaling_factor
    return inv.astype(np.float32)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (b, s, h, hd); cos/sin: (s, hd/2), or (b, s, hd/2) for per-row
    positions. Computes in f32."""
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def quantize_kernel_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an (in, out) kernel →
    (kernel_q int8 (in, out), scale f32 (out,)); runs where w lives."""
    w = w.float()
    scale = divide_exactly(torch.clamp_min(w.abs().amax(dim=0, keepdim=True), 1e-8), 127.0)
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale[0]


def quantize_experts_int8(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked experts (E, in, out) → (int8 (E, in, out), f32 scales (E, out)):
    each expert per output channel, as ``quantize_kernel_int8``; one expert
    at a time, where w lives, so the f32 transient stays one expert."""
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], w.shape[2]), dtype=torch.float32, device=w.device)
    for e in range(w.shape[0]):
        q[e], s[e] = quantize_kernel_int8(w[e])
    return q, s


def quantize_experts_int4(experts: Iterable[torch.Tensor], group: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Experts, each (in, out) (a stacked (E, in, out) tensor iterates so; a
    generator can draw them one at a time) → (packed (E, in/2, out) int8,
    f32 group scales (E, in/group, out)): each expert
    ``quantize_int4_groupwise``'d where it lives (``group`` 0:
    int4_tiling's)."""
    parts = [quantize_int4_groupwise(w, group=group or None) for w in experts]
    return torch.stack([p for p, _ in parts]), torch.stack([s for _, s in parts])


class QuantDense(nn.Module):
    """Weight-only linear: int8 (per-output-channel scale), packed int4
    (group-wise scales), or a plain f32 kernel when quantization is off.
    int8: rows ≤ 8 with 512-multiple dims take the int8 kernel
    (``use_kernel``), other shapes dequantize and multiply. int4: every
    shape goes through ``int4_matmul``, which routes by shape (W4A8 with
    ``a8``). ``use_bias`` adds an f32 ``bias`` after the product under every
    quantization, rounded back to the product's dtype.

    With ``shard`` (a shard of the model axis) the layer holds its local
    part by the logical ``names`` of its (in, out) dims: column-parallel
    (``embed`` → ``qkv``/``kv``/``mlp``) keeps its output columns and takes
    the whole input; row-parallel (``qkv``/``mlp`` → ``embed``) keeps its
    input rows, takes its shard of the input features and returns its
    partial product, which the caller sums over the shards (``psum``; no
    row-parallel layer of the decoder has a bias). The routes follow the
    local shapes, with the JAX package's gates: int8 as on one device (the
    kernel at ≤ 8 rows with 512-multiple local dims); int4 through
    ``int4_matmul`` only when the global packing tile and scale group
    divide the local k and 512 divides the local n, else the weights of
    the shard dequantized in the model dtype and multiplied. A row shard of
    a packed int4 weight is packed over its own rows (``int4_tiling`` of
    its k: the byte slice itself when the global tile divides it)."""

    def __init__(self, in_features: int, features: int, quantize: bool,
                 dtype: torch.dtype, use_kernel: bool = False, device=None,
                 bits: int = 8, q_group: int = 0, a8: bool = False,
                 use_bias: bool = False, names: Tuple[str, str] = ("embed", "embed"),
                 shard: Optional[ModelShard] = None):
        super().__init__()
        k_l, n_l = _local(shard, in_features, names[0]), _local(shard, features, names[1])
        self.shard = shard
        self.row = k_l != in_features  # a partial product over the shard's rows
        if use_bias and self.row:
            raise ValueError("a row-parallel QuantDense takes no bias")
        self.features = n_l
        self.quantize = quantize
        self.dtype = dtype
        self.use_kernel = use_kernel
        self.bits = bits
        self.a8 = a8
        if quantize and bits == 4:
            self.tile_k, self.group = int4_tiles(in_features, q_group)
            self.register_buffer("kernel_p", torch.zeros(
                _local(shard, in_features // 2, names[0]), n_l, dtype=torch.int8,
                device=device))
            self.register_buffer("gscale", torch.ones(
                _local(shard, in_features // self.group, names[0]), n_l, device=device))
        elif quantize:
            self.register_buffer("kernel_q", torch.zeros(
                k_l, n_l, dtype=torch.int8, device=device))
            self.register_buffer("scale", torch.ones(n_l, device=device))
        else:
            self.kernel = nn.Parameter(torch.zeros(k_l, n_l, device=device))
        self.bias = nn.Parameter(torch.zeros(n_l, device=device)) if use_bias else None

    def _int4_shard(self, x2: torch.Tensor) -> torch.Tensor:
        """The int4 product of a shard: the kernel route where the JAX
        package's local gate passes, else its fallback."""
        k = x2.shape[1]
        if k % self.tile_k == 0 and k % self.group == 0 and self.features % INT4_TILE_N == 0:
            return int4_matmul(x2, self.kernel_p, self.gscale, a8=self.a8)
        w = unpack_int4(self.kernel_p, int4_tiling(k)[0]).to(self.dtype)
        s = self.gscale.to(self.dtype).repeat_interleave(self.group, dim=0)
        if s.shape[0] != k:
            # a row shard whose scale rows the axis does not divide holds them all
            s = s[self.shard.index * k:(self.shard.index + 1) * k]
        return x2 @ (w * s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lead = x.shape[:-1]
        d_in = x.shape[-1]
        x2 = x.reshape(-1, d_in)
        if not self.quantize:
            out = x2 @ self.kernel.to(self.dtype)
        elif self.bits == 4 and self.shard is not None:
            out = self._int4_shard(x2.to(self.dtype))
        elif self.bits == 4:
            out = int4_matmul(x2.to(self.dtype), self.kernel_p, self.gscale,
                              a8=self.a8)
        elif (self.use_kernel and x2.shape[0] <= MAX_ROWS
              and d_in % 512 == 0 and self.features % 512 == 0):
            # decode: the int8 weights are read once, dequant in the epilogue
            out = int8_matmul(x2.to(self.dtype), self.kernel_q, self.scale)
        else:
            wd = self.kernel_q.to(self.dtype) * self.scale.to(self.dtype)[None, :]
            out = x2.to(self.dtype) @ wd
        if self.bias is not None:
            out = (out + self.bias).to(out.dtype)
        return out.reshape(*lead, self.features)


def quant_dense(cfg: LlamaConfig, in_features: int, features: int,
                device=None, use_bias: bool = False,
                names: Tuple[str, str] = ("embed", "embed"),
                shard: Optional[ModelShard] = None) -> QuantDense:
    """A projection of the decoder with the config's quantization."""
    return QuantDense(in_features, features, cfg.quantization != "none",
                      cfg.torch_dtype, cfg.quant_kernel, device,
                      bits=4 if cfg.quantization == "int4" else 8,
                      q_group=cfg.int4_group, a8=cfg.int4_w4a8, use_bias=use_bias,
                      names=names, shard=shard)


class LlamaAttention(nn.Module):
    """GQA attention with RoPE. ``window``: this layer's sliding window (-1
    takes ``cfg.sliding_window``, 0 is full attention). The family branches
    follow the config: one ``qkv_proj`` (``fused_projections``), q/k/v
    biases, per-head ``q_norm``/``k_norm`` before rope, ``query_scale`` and
    the logit softcap. Prefill takes the flash kernel only where its plain
    causal softmax is the layer's: no softcap, and a window (if any) that
    holds every key.

    With ``shard`` the layer holds its shard's heads (nh / D query and
    nkv / D kv heads, the group size of one device): q/k/v column-parallel,
    the attention on the local heads, o_proj row-parallel (the output is
    the shard's partial). The full prefill (``ring``) of a shard whose
    corpus axis has n > 1 devices takes the ring over them when n divides
    both lengths and the plain causal softmax is the layer's (the JAX
    package's conditions), ahead of flash."""

    def __init__(self, cfg: LlamaConfig, device=None, window: int = -1,
                 shard: Optional[ModelShard] = None):
        super().__init__()
        self.cfg = cfg
        self.window = cfg.sliding_window if window < 0 else window
        self.ring_devices = shard.ring_devices if shard is not None else ()
        c = cfg
        hd, nh, nkv = c.head_dim, c.num_heads, c.num_kv_heads
        self.nh, self.nkv = _local(shard, nh, "qkv"), _local(shard, nkv, "kv")

        def dense(i, o, names, bias=False):
            return quant_dense(c, i, o, device, use_bias=bias, names=names, shard=shard)
        if c.fused_projections:
            self.qkv_proj = dense(c.hidden_size, (nh + 2 * nkv) * hd, ("embed", "qkv"),
                                  c.qkv_bias)
        else:
            self.q_proj = dense(c.hidden_size, nh * hd, ("embed", "qkv"), c.qkv_bias)
            self.k_proj = dense(c.hidden_size, nkv * hd, ("embed", "kv"), c.qkv_bias)
            self.v_proj = dense(c.hidden_size, nkv * hd, ("embed", "kv"), c.qkv_bias)
        if c.qk_norm:
            self.q_norm = RMSNorm(hd, c.rms_eps, c.torch_dtype, device)
            self.k_norm = RMSNorm(hd, c.rms_eps, c.torch_dtype, device)
        self.o_proj = dense(nh * hd, c.hidden_size, ("qkv", "embed"))

    def forward(self, x, cos, sin, attn_bias=None, cache=None, cache_pos=0,
                paged_state=None, capture=False, ring=False):
        """→ (output, capture): ``capture`` True gives the softmax weights
        (b, nh, s, kv_len) from the einsum path (flash is off for it);
        ``"qk"`` gives the post-RoPE (q, k), k repeated to the query heads,
        with flash allowed; otherwise None. Query row i sits at position
        ``cache_pos + i`` (the window's lower bound). ``ring``: this is the
        full prefill from position 0 (the ring derives positions from the
        block index)."""
        c = self.cfg
        b, s, _ = x.shape
        hd, nh, nkv = c.head_dim, self.nh, self.nkv
        dt = c.torch_dtype
        if c.fused_projections:
            qkv = self.qkv_proj(x)
            q, k, v = qkv.split([nh * hd, nkv * hd, nkv * hd], dim=-1)
        else:
            q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        q = q.reshape(b, s, nh, hd)
        k = k.reshape(b, s, nkv, hd)
        v = v.reshape(b, s, nkv, hd)
        if c.qk_norm:
            q, k = self.q_norm(q), self.k_norm(k)
        # rope rotates in f32, then back to the model dtype
        q = apply_rope(q, cos, sin).to(dt)
        k = apply_rope(k, cos, sin).to(dt)
        if paged_state is not None:
            return self.o_proj(self._paged(q, k, v, paged_state)), None
        if cache is not None:
            ck, cv = cache  # (b, L, nkv, hd), updated in place
            ck[:, cache_pos:cache_pos + s] = k
            cv[:, cache_pos:cache_pos + s] = v
            k, v = ck, cv
        rep = nh // nkv
        scale = c.query_scale or 1.0 / float(np.sqrt(hd))
        kv_len = k.shape[1]
        win = self.window
        plain_softmax = (win == 0 or kv_len <= win) and not c.attn_softcap
        ring_n = len(self.ring_devices)
        use_ring = (ring and ring_n > 1 and s > 1 and plain_softmax and not capture
                    and s % ring_n == 0 and kv_len % ring_n == 0)
        use_flash = (c.use_flash and capture is not True and s > 1
                     and s % FLASH_BLOCK == 0 and kv_len % FLASH_BLOCK == 0
                     and plain_softmax)
        weights = None
        if use_ring:
            # sequence-parallel prefill: heads folded head-major into dim 0,
            # the sequence split over the corpus devices; padded keys sit
            # past every real query row, so the causal mask hides them
            kr = k.repeat_interleave(rep, dim=2)
            vr = v.repeat_interleave(rep, dim=2)
            of = ring_attention(q.permute(2, 0, 1, 3).reshape(nh * b, s, hd),
                                kr.permute(2, 0, 1, 3).reshape(nh * b, kv_len, hd),
                                vr.permute(2, 0, 1, 3).reshape(nh * b, kv_len, hd),
                                self.ring_devices, causal=True, sm_scale=scale)
            out = of.reshape(nh, b, s, hd).permute(1, 2, 0, 3)
        elif use_flash:
            # prefill: causal flash; padded keys sit past every real query
            # row, so the causal mask subsumes the padding mask (the additive
            # bias is not read, as in the JAX flash path)
            kf = k.transpose(1, 2).reshape(b * nkv, kv_len, hd)
            vf = v.transpose(1, 2).reshape(b * nkv, kv_len, hd)
            if rep > 1:
                qg = q.transpose(1, 2).reshape(b * nkv, rep, s, hd)
                og = flash_attention_gqa(qg, kf, vf, causal=True, sm_scale=scale)
            else:
                qf = q.transpose(1, 2).reshape(b * nh, s, hd)
                og = flash_attention(qf, kf, vf, causal=True, sm_scale=scale)
            out = og.reshape(b, nh, s, hd).transpose(1, 2)
        else:
            # grouped-query attention without repeating K/V: q head h reads
            # kv head h // rep
            q5 = q.reshape(b, s, nkv, rep, hd)
            logits = torch.einsum("bqnrd,bknd->bnrqk", q5.float(), k.float()) * scale
            if c.attn_softcap:
                # on the scaled logits, before the additive mask
                logits = torch.tanh(logits / c.attn_softcap) * c.attn_softcap
            if attn_bias is not None:
                logits = logits + attn_bias[..., None, :, :]
            if win:
                # the window's lower bound: keys > position - window
                qpos = cache_pos + torch.arange(s, device=x.device)
                keep = torch.arange(kv_len, device=x.device)[None, :] > qpos[:, None] - win
                logits = torch.where(keep, logits, -1e30)
            weights = torch.softmax(logits, dim=-1)
            out = torch.einsum("bnrqk,bknd->bqnrd", weights.to(dt), v)
        aux = None
        if capture == "qk":
            aux = (q, k.repeat_interleave(rep, dim=2))
        elif capture:
            aux = weights.reshape(b, nh, s, kv_len)
        return self.o_proj(out.reshape(b, s, nh * hd)), aux

    def _paged(self, q, k, v, paged_state):
        """Write this step's K/V into the pool in place and attend it.
        s == 1: batched decode. s > 1: chunk-append (chunked prefill),
        batched when ``pages`` is 2-D (b, s), else one sequence. Padded
        tail tokens point at a trash page and sit past every real row's
        causal limit."""
        k_pages, v_pages, page_idx, lengths, pages, slots = paged_state
        b, s, nh, hd = q.shape
        c = self.cfg
        kw = dict(window=self.window, sm_scale=c.query_scale or None,
                  softcap=c.attn_softcap)
        if s == 1:
            paged_update_token(k_pages, k[:, 0].transpose(0, 1), pages, slots)
            paged_update_token(v_pages, v[:, 0].transpose(0, 1), pages, slots)
            out = paged_attention(q[:, 0], k_pages, v_pages, page_idx, lengths, **kw)
        elif pages.dim() == 2:
            paged_update_chunk(k_pages, k.permute(2, 0, 1, 3), pages, slots)
            paged_update_chunk(v_pages, v.permute(2, 0, 1, 3), pages, slots)
            out = paged_attention_chunk(q, k_pages, v_pages, page_idx, lengths, **kw)
        else:
            # 1-D pages/slots address ONE sequence's rows; a b > 1 chunk
            # would attend unwritten K/V
            if b != 1:
                raise ValueError("paged chunk-append with 1-D pages needs batch 1")
            paged_update_token(k_pages, k[0].transpose(0, 1), pages, slots)
            paged_update_token(v_pages, v[0].transpose(0, 1), pages, slots)
            out = paged_attention_chunk(q, k_pages, v_pages, page_idx, lengths, **kw)
        return out.reshape(b, s, nh * hd).to(self.cfg.torch_dtype)


class LlamaMlp(nn.Module):
    """The gated MLP; with ``shard``, gate/up column-parallel and down_proj
    row-parallel (the output is the shard's partial)."""

    def __init__(self, cfg: LlamaConfig, device=None, shard: Optional[ModelShard] = None):
        super().__init__()
        h, f = cfg.hidden_size, cfg.intermediate_size
        self.act = activation(cfg.act_fn)
        self.fused = cfg.fused_projections
        up, down = ("embed", "mlp"), ("mlp", "embed")
        if self.fused:
            self.gate_up_proj = quant_dense(cfg, h, 2 * f, device, names=up, shard=shard)
        else:
            self.gate_proj = quant_dense(cfg, h, f, device, names=up, shard=shard)
            self.up_proj = quant_dense(cfg, h, f, device, names=up, shard=shard)
        self.down_proj = quant_dense(cfg, f, h, device, names=down, shard=shard)

    def forward(self, x):
        if self.fused:
            g, u = self.gate_up_proj(x).chunk(2, dim=-1)
        else:
            g, u = self.gate_proj(x), self.up_proj(x)
        return self.down_proj(self.act(g) * u)


class LlamaMoeMlp(nn.Module):
    """Top-k routed sparse-MoE MLP (Mixtral / Qwen3-MoE family), the JAX
    package's LlamaMoeMlp on one device.

    Routing stays f32: router logits, softmax over all experts, top-k with
    ties to the lowest index, renormalized when ``norm_topk_prob``. With
    t tokens and S = t·top_k (token, slot) rows:

    - S ≤ E (decode): per-slot expert-gathered matmuls (#10), reading only
      the routed experts' weights;
    - E < S ≤ 4E under ``moe_grouped="auto"`` (batched decode), or any S
      under ``"on"``: the rows sorted by expert (a stable sort) through
      grouped matmuls; the dedup route (#11, 16- or 8-row tiles) reads each
      unique routed expert once, ``"on"`` prefill takes the full-stack
      route (#12);
    - otherwise (prefill under "auto"): every expert on every token in the
      model dtype, combined with f32 one-hot routing weights.

    Packed-int4 experts take the JAX package's int4 routes, in its order:
    (a) E < S ≤ 4E under "auto" where ``grouped_int4_viable`` holds for the
    up and the down shapes: the sorted rows through the dedup-grouped int4
    kernel (#14); (b) else S ≤ E or S ≤ min(64, 4E): the per-slot int4
    gather (#13); (c) else every stack dequantized in the model dtype and
    the einsum above. ``"on"`` reaches no grouped kernel with int4 experts.

    Slot outputs are combined in f32 times their routing weight, summed
    over top_k in slot order. Parameters keep the flax names: ``router``
    (h, E) f32; int8 ``gate_q``/``up_q``/``down_q`` (E, in, out) with
    ``gate_s``/``up_s``/``down_s`` (E, out); int4 ``gate_p``/``up_p``/
    ``down_p`` (E, in/2, out) with ``gate_gs``/``up_gs``/``down_gs``
    (E, in/group, out); float ``gate``/``up``/``down``. Nothing here reads a
    device value on the host.

    With ``shard`` the layer holds E / D experts and E / D router columns;
    ``shard_partial`` computes its share from the gathered router logits
    (the JAX package's mesh routes): the expert-parallel decode gather
    when S ≤ E / D, else the all-experts einsum on the local experts."""

    def __init__(self, cfg: LlamaConfig, device=None, shard: Optional[ModelShard] = None):
        super().__init__()
        self.cfg = cfg
        self.shard = shard
        h = cfg.hidden_size
        e = _local(shard, cfg.num_experts, "expert")
        f = cfg.moe_intermediate_size or cfg.intermediate_size
        self.router = nn.Parameter(torch.zeros(h, e, device=device))
        self.act = activation(cfg.act_fn)
        shapes = {"gate": (h, f), "up": (h, f), "down": (f, h)}
        for name, (i, o) in shapes.items():
            if cfg.quantization == "int4":
                group = int4_tiles(i, cfg.int4_group)[1]
                self.register_buffer(f"{name}_p", torch.zeros(
                    e, i // 2, o, dtype=torch.int8, device=device))
                self.register_buffer(f"{name}_gs", torch.ones(
                    e, i // group, o, device=device))
            elif cfg.quantization == "int8":
                self.register_buffer(f"{name}_q", torch.zeros(
                    e, i, o, dtype=torch.int8, device=device))
                self.register_buffer(f"{name}_s", torch.ones(e, o, device=device))
            else:
                setattr(self, name, nn.Parameter(torch.zeros(e, i, o, device=device)))

    def experts(self, name: str):
        """(stacked weights, scales or None) of projection ``name``."""
        if self.cfg.quantization == "int4":
            return getattr(self, f"{name}_p"), getattr(self, f"{name}_gs")
        if self.cfg.quantization == "int8":
            return getattr(self, f"{name}_q"), getattr(self, f"{name}_s")
        return getattr(self, name), None

    def router_logits(self, xf: torch.Tensor) -> torch.Tensor:
        """xf (t, h) → f32 router logits (t, E) (a shard: its E / D columns)."""
        return xf.float() @ self.router.float()

    def route(self, xf: torch.Tensor, logits: Optional[torch.Tensor] = None,
              records: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """xf (t, h), or the router ``logits`` over every expert → (top-k
        weights (t, k) f32, expert ids (t, k)). ``records`` (a train step's
        collector) gets the softmax ``router_probs`` (t, E) and the ids
        ``router_topi`` appended, as the JAX layer sows them; the weights
        keep their autograd edge to the router through the sort."""
        if logits is None:
            logits = self.router_logits(xf)
        probs = torch.softmax(logits, dim=-1)
        topw, topi = rank_topk(probs, self.cfg.num_experts_per_tok)
        if records is not None:
            records.setdefault("router_probs", []).append(probs)
            records.setdefault("router_topi", []).append(topi)
        if self.cfg.norm_topk_prob:
            topw = topw / topw.sum(dim=-1, keepdim=True)
        return topw, topi

    def dequant(self, w: torch.Tensor, s: Optional[torch.Tensor]) -> torch.Tensor:
        """A stack in the model dtype: int4 unpacked and group-scaled, int8
        times its per-channel scales, float cast."""
        c = self.cfg
        if c.quantization == "int4":
            return dequant_int4_stack(w, s, *int4_tiles(2 * w.shape[1], c.int4_group),
                                      c.torch_dtype)
        w = w.to(c.torch_dtype)
        return w if s is None else w * s[:, None, :].to(c.torch_dtype)

    def gathered(self, xs: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The slot rows xs (S, h) through the experts ``ids`` (S,) of this
        layer's stacks, gathered: #13 for int4 experts, #10 otherwise →
        (S, h) in the model dtype."""
        c = self.cfg
        dt, act = c.torch_dtype, self.act
        (wg, sg), (wu, su), (wn, sn) = (self.experts(p) for p in ("gate", "up", "down"))
        if c.quantization == "int4":
            (tk_h, g_h), (tk_f, g_f) = (int4_tiles(c.hidden_size, c.int4_group),
                                        int4_tiles(wg.shape[2], c.int4_group))
            a = (act(moe_gather_matmul_int4(xs, wg, sg, ids, tk_h, g_h))
                 * moe_gather_matmul_int4(xs, wu, su, ids, tk_h, g_h)).to(dt)
            return moe_gather_matmul_int4(a, wn, sn, ids, tk_f, g_f)
        a = (act(moe_gather_matmul(xs, wg, ids, sg))
             * moe_gather_matmul(xs, wu, ids, su)).to(dt)
        return moe_gather_matmul(a, wn, ids, sn)

    def all_experts(self, xf: torch.Tensor, topw: torch.Tensor, topi: torch.Tensor,
                    lo: int = 0) -> torch.Tensor:
        """Every expert of this layer's stacks on every token of xf (t, h)
        in the model dtype (int4 stacks dequantized first), combined with
        their f32 one-hot routing weights: the experts are global ids
        [lo, lo + E here) → (t, h) f32. A plain product outside any kernel,
        as in the JAX package."""
        wg, sg = self.experts("gate")
        xb = xf.to(self.cfg.torch_dtype)
        cw = torch.zeros(xf.shape[0], self.cfg.num_experts, device=xf.device
                         ).scatter_add_(1, topi, topw)
        g = torch.einsum("th,ehf->etf", xb, self.dequant(wg, sg))
        u = torch.einsum("th,ehf->etf", xb, self.dequant(*self.experts("up")))
        y = torch.einsum("etf,efh->eth", self.act(g) * u, self.dequant(*self.experts("down")))
        return torch.einsum("te,eth->th", cw[:, lo:lo + wg.shape[0]], y.float())

    def shard_partial(self, x: torch.Tensor, logits: torch.Tensor,
                      records: Optional[dict] = None):
        """This shard's share of the layer under the model axis: x (..., h)
        replicated, ``logits`` the router logits over every expert (the
        shards' columns gathered). → (f32 partial, finish): the caller sums
        the shards' partials (``psum``) and applies ``finish``.

        S = t·top_k ≤ E / D: the expert-parallel decode gather. The routed
        ids are rebased into the shard's range [lo, lo + E / D); the shard
        runs the gather kernel (#10 for int8 and float experts, #13 for
        int4) on its own experts, slots routed elsewhere clamp to local
        expert 0 with a combine weight of 0; the partial is the weighted
        slot outputs (S, h), summed over top_k after the psum. Otherwise the
        all-experts einsum on the local experts."""
        c = self.cfg
        top_k, h, dt = c.num_experts_per_tok, c.hidden_size, c.torch_dtype
        lead = x.shape[:-1]
        xf = x.reshape(-1, h)
        t = xf.shape[0]
        s_tot = t * top_k
        topw, topi = self.route(xf, logits, records)
        e_l = self.router.shape[1]
        lo = self.shard.index * e_l
        if s_tot <= e_l:
            ids = topi.reshape(s_tot)
            mine = (ids >= lo) & (ids < lo + e_l)
            y = self.gathered(xf.to(dt).repeat_interleave(top_k, dim=0),
                              torch.where(mine, ids - lo, 0))
            part = y.float() * torch.where(mine, topw.reshape(s_tot), 0.0)[:, None]

            def finish(y):
                return y.reshape(t, top_k, h).sum(dim=1).to(dt).reshape(*lead, h)
            return part, finish
        return self.all_experts(xf, topw, topi, lo), lambda y: y.to(dt).reshape(*lead, h)

    def forward(self, x: torch.Tensor, records: Optional[dict] = None) -> torch.Tensor:
        c = self.cfg
        e, top_k, h = c.num_experts, c.num_experts_per_tok, c.hidden_size
        dt = c.torch_dtype
        lead = x.shape[:-1]
        xf = x.reshape(-1, h)
        t = xf.shape[0]
        s_tot = t * top_k
        topw, topi = self.route(xf, records=records)
        (wg, sg), (wu, su), (wn, sn) = (self.experts(p) for p in ("gate", "up", "down"))
        act = self.act

        def combine(y):
            y = y.float() * topw.reshape(s_tot, 1)
            return y.reshape(t, top_k, h).sum(dim=1).to(dt).reshape(*lead, h)

        # decode rows: row s = token s // top_k, expert slot s % top_k
        ids = topi.reshape(s_tot)

        def sorted_rows():
            """(slot rows sorted by expert, stably: slot order within a group;
            group sizes; the inverse order)"""
            order = torch.argsort(ids, stable=True)
            # group sizes without a host read (bincount reads its max)
            gsz = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
                0, ids, torch.ones_like(ids))
            return (xf.to(dt).repeat_interleave(top_k, dim=0)[order], gsz,
                    torch.argsort(order))

        quant4 = c.quantization == "int4"
        if quant4:
            f = wg.shape[2]
            (tk_h, g_h), (tk_f, g_f) = int4_tiles(h, c.int4_group), int4_tiles(f, c.int4_group)
            if (c.moe_grouped == "auto" and e < s_tot <= 4 * e
                    and grouped_int4_viable(s_tot, e, h, f, tk_h, g_h, dt)
                    and grouped_int4_viable(s_tot, e, f, h, tk_f, g_f, dt)):
                # (a) batched decode: each unique routed expert read once (#14)
                xs, gsz, inv = sorted_rows()
                a = (act(moe_grouped_matmul_int4(xs, wg, sg, gsz, tk_h, g_h))
                     * moe_grouped_matmul_int4(xs, wu, su, gsz, tk_h, g_h)).to(dt)
                return combine(moe_grouped_matmul_int4(a, wn, sn, gsz, tk_f, g_f)[inv])
        if s_tot <= e or (quant4 and s_tot <= min(GATHER_MAX_SLOTS, 4 * e)):
            # decode: the routed slots' weights only ((b) for int4: packed bytes)
            return combine(self.gathered(xf.to(dt).repeat_interleave(top_k, dim=0), ids))

        dedup = c.moe_grouped == "auto" and e < s_tot <= 4 * e
        if not quant4 and (c.moe_grouped == "on" or dedup):
            xs, gsz, inv = sorted_rows()
            # dedup: a decode-sized m-tile, the largest k/n tiles that
            # divide (the JAX package's sweep); "on" keeps the defaults
            tm = (16 if dt == torch.bfloat16 else 8) if dedup else 0

            def tiles(k, n):
                if not dedup or e * (tm - 1) > 1024:
                    return 0, 0
                return (next((v for v in (2048, 1024, 512) if k % v == 0), 0),
                        next((v for v in (1024, 512) if n % v == 0), 0))
            (tk_up, tn_up), (tk_dn, tn_dn) = tiles(h, wg.shape[2]), tiles(wg.shape[2], h)
            a = (act(moe_grouped_matmul(xs, wg, gsz, sg, tm, tk_up, tn_up, dedup))
                 * moe_grouped_matmul(xs, wu, gsz, su, tm, tk_up, tn_up, dedup)).to(dt)
            y = moe_grouped_matmul(a, wn, gsz, sn, tm, tk_dn, tn_dn, dedup)
            return combine(y[inv])

        # (c) for int4: every stack dequantized, as at prefill
        return self.all_experts(xf, topw, topi).to(dt).reshape(*lead, h)


class LlamaBlock(nn.Module):
    """Pre-norm block; with ``post_norms`` (Gemma-2) norms around each
    sublayer: post_attn_norm on the attention output, pre_ffw_norm and
    post_ffw_norm around the MLP. ``forward`` is the attention on
    ``input_norm``, ``add_attention``, the MLP on ``mlp_input`` and
    ``add_mlp``; ``ShardedLlamaModel`` runs the same steps with its sums
    between them."""

    def __init__(self, cfg: LlamaConfig, device=None, moe: bool = False,
                 window: int = -1, shard: Optional[ModelShard] = None):
        super().__init__()
        dt = cfg.torch_dtype
        self.post_norms = cfg.post_norms
        self.moe = moe

        def norm():
            return RMSNorm(cfg.hidden_size, cfg.rms_eps, dt, device, offset=cfg.norm_offset)
        self.input_norm = norm()
        self.attention = LlamaAttention(cfg, device, window, shard)
        self.post_attn_norm = norm()
        if cfg.post_norms:
            self.pre_ffw_norm = norm()
            self.post_ffw_norm = norm()
        self.mlp = (LlamaMoeMlp(cfg, device, shard) if moe
                    else LlamaMlp(cfg, device, shard))

    def add_attention(self, x, h):
        return x + (self.post_attn_norm(h) if self.post_norms else h)

    def mlp_input(self, x):
        return self.pre_ffw_norm(x) if self.post_norms else self.post_attn_norm(x)

    def add_mlp(self, x, m):
        return x + (self.post_ffw_norm(m) if self.post_norms else m)

    def forward(self, x, cos, sin, attn_bias, cache, cache_pos, paged_state=None,
                capture=False, ring=False, records=None):
        h, aux = self.attention(self.input_norm(x), cos, sin, attn_bias, cache,
                                cache_pos, paged_state, capture, ring)
        x = self.add_attention(x, h)
        xm = self.mlp_input(x)
        return self.add_mlp(x, self.mlp(xm, records) if self.moe else self.mlp(xm)), aux


class LlamaModel(nn.Module):
    """Causal LM over a dense KV cache (prefill: full prompt from position
    0; decode: one token at ``cache_pos``). With ``shard``: one shard's
    part of the model axis (its local widths; the vocabulary rows of the
    embedding and the head sharded when the axis divides them), driven by
    ``ShardedLlamaModel``."""

    def __init__(self, cfg: LlamaConfig, device=None, shard: Optional[ModelShard] = None):
        super().__init__()
        self.cfg = cfg
        c = cfg
        self.shard = shard
        vocab = _local(shard, c.vocab_size, "vocab")
        self.token_embedding = nn.Parameter(
            torch.zeros(vocab, c.hidden_size, device=device))
        self.layers = nn.ModuleList(
            LlamaBlock(c, device, c.is_moe_layer(i), c.layer_window(i), shard)
            for i in range(c.num_layers))
        self.final_norm = RMSNorm(c.hidden_size, c.rms_eps, c.torch_dtype, device,
                                  offset=c.norm_offset)
        if self.int8_head:
            self.register_buffer("lm_head_q", torch.zeros(
                c.hidden_size, vocab, dtype=torch.int8, device=device))
            self.register_buffer("lm_head_scale", torch.ones(vocab, device=device))
        elif not c.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros(c.hidden_size, vocab, device=device))
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_inv_freq(c.head_dim, c.rope_theta, cfg=c)).to(device),
            persistent=False)
        self._head_f32: Optional[torch.Tensor] = None

    @property
    def int8_head(self) -> bool:
        return self.cfg.head_quantization == "int8" and not self.cfg.tie_embeddings

    def embed_rows(self, input_ids: torch.Tensor) -> torch.Tensor:
        """The embedding rows of ``input_ids`` in the embedding's dtype. A
        shard holding the vocabulary rows [lo, lo + V / D) gives its own
        rows and zeros elsewhere, so the sum over the shards is the lookup."""
        emb = self.token_embedding
        if emb.shape[0] == self.cfg.vocab_size:
            return emb[input_ids]
        local = input_ids - self.shard.index * emb.shape[0]
        mine = (local >= 0) & (local < emb.shape[0])
        rows = emb[local.clamp(0, emb.shape[0] - 1)]
        return torch.where(mine[..., None], rows, torch.zeros((), dtype=emb.dtype,
                                                               device=emb.device))

    def embedded(self, rows: torch.Tensor) -> torch.Tensor:
        """Embedding rows → the first hidden states (model dtype; Gemma's
        scale by sqrt(hidden) rounded to the model dtype first, as HF
        rounds it)."""
        c = self.cfg
        x = rows.to(c.torch_dtype)
        if c.embed_scale:
            x = x * torch.tensor(float(np.sqrt(c.hidden_size)), dtype=c.torch_dtype,
                                 device=x.device)
        return x

    def rope(self, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """cos and sin at ``positions`` ((s,) or (b, s))."""
        ang = positions.float()[..., None] * self.inv_freq
        return torch.cos(ang), torch.sin(ang)

    def select_rows(self, x: torch.Tensor, head_at) -> torch.Tensor:
        """The rows the head reads: all, one offset, or (b,) per-row offsets."""
        if isinstance(head_at, torch.Tensor):
            return x[torch.arange(x.shape[0], device=x.device), head_at.long()][:, None]
        if head_at is not None:
            return x[:, head_at:head_at + 1]
        return x

    def empty_caches(self, batch: int, cache_len: int) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Zeroed dense KV caches, per layer (k, v) of (batch, cache_len, nkv, hd)."""
        c = self.cfg
        dev = self.token_embedding.device
        nkv = self.layers[0].attention.nkv
        return [tuple(torch.zeros((batch, cache_len, nkv, c.head_dim), dtype=c.torch_dtype,
                                  device=dev) for _ in range(2))
                for _ in range(c.num_layers)]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """f32 logits of the final hidden states x (..., hidden): f32 sums of
        products of the head's values. A float head may be stored in bf16;
        it is widened once and kept (serving never changes weights), unless
        it takes a gradient (a train step's head is read as it stands). The
        int8 head computes as the JAX package's does: each weight
        ``lm_head_q * lm_head_scale`` in the model dtype, then a product
        with f32 sums. It dequantizes a strip of at most HEAD_STRIP_BYTES
        of f32 weights at a time and keeps none, so the head that is read
        stays the int8 one."""
        if not self.int8_head:
            w = self.token_embedding.T if self.cfg.tie_embeddings else self.lm_head
            if w.requires_grad:
                return x.to(w.dtype).float() @ w.float()
            if self._head_f32 is None:
                self._head_f32 = w.detach().float()
            return x.to(w.dtype).float() @ self._head_f32
        dt = self.cfg.torch_dtype
        xf = x.to(dt).float()
        hq, hs = self.lm_head_q, self.lm_head_scale
        vocab = hq.shape[1]
        out = torch.empty(x.shape[:-1] + (vocab,), dtype=torch.float32, device=x.device)
        strip = max(1, HEAD_STRIP_BYTES // (4 * hq.shape[0]))
        for c0 in range(0, vocab, strip):
            w = (hq[:, c0:c0 + strip].to(dt) * hs[c0:c0 + strip].to(dt)[None, :]).float()
            out[..., c0:c0 + strip] = xf @ w
        return out

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None,
                caches: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                cache_pos: int = 0, head_at=None,
                paged_caches: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                paged_meta: Optional[tuple] = None, skip_head: bool = False,
                capture_weights: bool = False, capture_qk_last: bool = False,
                ring: bool = False, router_records: Optional[dict] = None):
        """→ f32 logits (b, s, vocab), or (b, 1, vocab) at ``head_at`` (an
        int, or a (b,) tensor of per-row offsets). positions: (s,) or (b, s).
        ``ring``: the full prefill from position 0, which may take the ring
        (a shard with corpus devices; see ``LlamaAttention``).
        ``router_records`` (a dict) collects each MoE layer's router state
        in layer order (``LlamaMoeMlp.route``): a train step's load-balancing
        loss reads it; nothing is held when it is None.

        ``paged_caches`` (per layer (k_pages, v_pages)) with ``paged_meta``
        (page_idx, lengths, pages, slots) attends the paged pool and writes
        this call's K/V into it in place. ``skip_head`` returns None after
        the layers (a chunked-prefill chunk whose logits nobody reads).

        With ``capture_weights`` or ``capture_qk_last`` the result is a dict
        {"logits", "attn_weights": per-layer softmax weights (b, nh, s,
        kv_len), "qk_last": the last layer's post-RoPE (q, k), each
        (b, s, nh, hd)}, as the JAX package's model returns."""
        c = self.cfg
        x = self.embedded(self.embed_rows(input_ids))
        cos, sin = self.rope(positions)
        all_w, qk_last = [], None
        for i, layer in enumerate(self.layers):
            cache = caches[i] if caches is not None else None
            pstate = None
            if paged_caches is not None:
                pstate = tuple(paged_caches[i]) + tuple(paged_meta)
            cap = capture_weights
            if capture_qk_last and i == c.num_layers - 1:
                cap = "qk"
            x, aux = layer(x, cos, sin, attn_bias, cache, cache_pos, pstate, cap, ring,
                           router_records)
            if cap == "qk":
                qk_last = aux
            elif capture_weights:
                all_w.append(aux)
        if skip_head:
            return None
        logits = self.logits(self.select_rows(self.final_norm(x), head_at))
        if c.final_softcap:
            logits = torch.tanh(logits / c.final_softcap) * c.final_softcap
        if not (capture_weights or capture_qk_last):
            return logits
        out = {"logits": logits}
        if capture_weights:
            out["attn_weights"] = all_w
        if capture_qk_last:
            out["qk_last"] = qk_last
        return out


def sharded_mesh(mesh) -> bool:
    """Whether ``LocalLLM`` shards over ``mesh``: a model axis of more than
    one shard, or a corpus axis of more than one device (the ring)."""
    return mesh is not None and (mesh.shape["model"] > 1 or mesh.shape["corpus"] > 1)


class ShardedLlamaModel(nn.Module):
    """The decoder over the model axis of a mesh: one ``LlamaModel`` a
    shard, each on its own device (``mesh.axis_devices("model")``; a device
    may repeat) with its own contiguous weights (``parallel/tp.py``'s
    ``tp_shard_model``). The same call as ``LlamaModel``'s: inputs and
    results on the first shard's device.

    Each layer runs once a shard on local widths, the residual stream
    replicated: the attention (q/k/v column-parallel, the shard's heads,
    its dense cache or page pool), ``psum`` of the o_proj partials,
    ``add_attention``; the MLP on ``mlp_input`` (dense: gate/up columns,
    down_proj rows; MoE: the router's columns gathered, then the shard's
    experts) and ``psum`` of its partials, ``add_mlp``. The norms and the
    residual adds run once per distinct device (shards on one device share
    them). The embedding is a
    masked lookup per shard summed by ``psum`` (one shard contributes each
    row, so the sum is exact), the head's logits per shard are gathered
    along the vocabulary, the captured attention along the heads. With a
    corpus axis of n > 1 devices the full prefill of each model shard rings
    over the n devices at corpus index 0..n-1 of its column.

    Caches are per layer a pair of per-shard lists: (k of each shard, v of
    each shard), dense (``empty_caches``) or paged (``PagedKVCache(mesh=)``).
    Kernel launches count by shard (``kernels.shard_scope``).

    ``trainable`` keeps the shards' weights as parameters that take
    gradients (a train step's model; serving freezes them). A weight that
    the model axis replicates is one parameter per shard, the shards on one
    device sharing its storage: each copy gets the gradient of the work it
    fed, and the train step sums them into one (``train.train``)."""

    def __init__(self, cfg: LlamaConfig, mesh, shard_states: Sequence[Dict[str, torch.Tensor]],
                 trainable: bool = False):
        super().__init__()
        n = mesh.shape["model"]
        dense_mlp = not all(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
        bad = [f"{name}={size}" for name, size in (
            ("num_heads", cfg.num_heads), ("num_kv_heads", cfg.num_kv_heads),
            ("intermediate_size", cfg.intermediate_size if dense_mlp else 0),
            ("num_experts", cfg.num_experts)) if size % n]
        if bad:
            raise ValueError(f"the model axis ({n}) must divide {', '.join(bad)}")
        if len(shard_states) != n:
            raise ValueError(f"{len(shard_states)} shard states for a {n}-way model axis")
        self.cfg = cfg
        self.mesh = mesh
        self.devices = [canonical(d) for d in mesh.axis_devices("model")]
        ring = mesh.devices[0]  # (corpus, model) at data index 0
        shards = []
        for i, state in enumerate(shard_states):
            spec = ModelShard(i, n, tuple(canonical(d) for d in ring[:, i])
                              if ring.shape[0] > 1 else ())
            with torch.device("meta"):
                model = LlamaModel(cfg, shard=spec)
            model.load_state_dict(state, strict=True, assign=True)
            model.inv_freq = torch.from_numpy(
                rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg=cfg)).to(self.devices[i])
            shards.append(model if trainable else model.requires_grad_(False).eval())
        self.shards = nn.ModuleList(shards)
        self.vocab_sharded = shards[0].token_embedding.shape[0] != cfg.vocab_size

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def empty_caches(self, batch: int, cache_len: int) -> list:
        per_shard = [m.empty_caches(batch, cache_len) for m in self.shards]
        return [tuple([s[i][j] for s in per_shard] for j in range(2))
                for i in range(self.cfg.num_layers)]

    def _each(self, mods, fn, *per_shard):
        """[fn(i, mods[i], *(a[i] for a in per_shard))] over the shards, the
        launches of each counted under its index."""
        from ragmeup_tpu_torch import kernels
        out = []
        for i, mod in enumerate(mods):
            with kernels.shard_scope(i):
                out.append(fn(i, mod, *(a[i] for a in per_shard)))
        return out

    def _replicated(self, mods, fn, *per_shard):
        """``_each`` for work on the replicated stream (norms, residual
        adds, rope): its inputs and weights are the same on every shard, so
        it runs once per distinct device and the shards there share it."""
        held, out = {}, []
        for i, dev in enumerate(self.devices):
            if dev not in held:
                held[dev] = fn(i, mods[i], *(a[i] for a in per_shard))
            out.append(held[dev])
        return out

    def forward(self, input_ids: torch.Tensor, positions: torch.Tensor,
                attn_bias: Optional[torch.Tensor] = None, caches: Optional[list] = None,
                cache_pos: int = 0, head_at=None, paged_caches: Optional[list] = None,
                paged_meta: Optional[tuple] = None, skip_head: bool = False,
                capture_weights: bool = False, capture_qk_last: bool = False,
                ring: bool = False, router_records: Optional[dict] = None):
        """``LlamaModel.forward`` over the shards (see the class); every
        shard routes on the gathered router logits alike, so shard 0's
        router state is the one ``router_records`` collects."""
        c = self.cfg
        devs = self.devices
        shards = list(self.shards)

        def put(t):
            return replicate(t, devs) if isinstance(t, torch.Tensor) else [t] * len(devs)
        ids, pos, bias, at = put(input_ids), put(positions), put(attn_bias), put(head_at)
        meta = [put(m) for m in paged_meta] if paged_meta is not None else None
        rows = self._each(shards, lambda i, m, t: m.embed_rows(t), ids)
        if self.vocab_sharded:
            rows = psum(rows)
        x = self._replicated(shards, lambda i, m, r: m.embedded(r), rows)
        rope = self._replicated(shards, lambda i, m, p: m.rope(p), pos)
        all_w, qk_last = [], None
        for li in range(c.num_layers):
            blocks = [m.layers[li] for m in shards]
            cap = capture_weights
            if capture_qk_last and li == c.num_layers - 1:
                cap = "qk"

            def attend(i, blk, xi, cs, b):
                cache = (caches[li][0][i], caches[li][1][i]) if caches is not None else None
                pstate = None
                if paged_caches is not None:
                    pstate = (paged_caches[li][0][i], paged_caches[li][1][i]) + tuple(
                        t[i] for t in meta)
                return blk.attention(xi, cs[0], cs[1], b, cache, cache_pos, pstate, cap, ring)
            xn = self._replicated(blocks, lambda i, blk, xi: blk.input_norm(xi), x)
            hs = self._each(blocks, attend, xn, rope, bias)
            h = psum([hi for hi, _ in hs])
            x = self._replicated(blocks, lambda i, blk, xi, hi: blk.add_attention(xi, hi), x, h)
            xm = self._replicated(blocks, lambda i, blk, xi: blk.mlp_input(xi), x)
            if blocks[0].moe:
                # the router's columns gathered, then each shard's experts
                logits = all_gather(self._each(
                    blocks, lambda i, blk, xi: blk.mlp.router_logits(xi.reshape(-1, c.hidden_size)),
                    xm), dim=-1)
                parts = self._each(blocks, lambda i, blk, xi, lg: blk.mlp.shard_partial(
                    xi, lg, router_records if i == 0 else None), xm, logits)
                finish = parts[0][1]
                mo = [finish(y) for y in psum([part for part, _ in parts])]
            else:
                mo = psum(self._each(blocks, lambda i, blk, xi: blk.mlp(xi), xm))
            x = self._replicated(blocks, lambda i, blk, xi, mi: blk.add_mlp(xi, mi), x, mo)
            if cap == "qk":
                qk_last = tuple(torch.cat([aux[j].to(devs[0]) for _, aux in hs], dim=2)
                                for j in range(2))
            elif capture_weights:
                all_w.append(torch.cat([aux.to(devs[0]) for _, aux in hs], dim=1))
        if skip_head:
            return None
        xf = self._replicated(shards, lambda i, m, xi, a: m.select_rows(m.final_norm(xi), a),
                              x, at)
        # a replicated head: shard 0's logits are every shard's
        head = self._each(shards, lambda i, m, xi: m.logits(xi)
                          if self.vocab_sharded or i == 0 else None, xf)
        logits = (all_gather(head, dim=-1, devices=devs[:1])[0] if self.vocab_sharded
                  else head[0])
        if c.final_softcap:
            logits = torch.tanh(logits / c.final_softcap) * c.final_softcap
        if not (capture_weights or capture_qk_last):
            return logits
        out = {"logits": logits}
        if capture_weights:
            out["attn_weights"] = all_w
        if capture_qk_last:
            out["qk_last"] = qk_last
        return out


def _next_pow2_int(x: int) -> int:
    n = 1
    while n < x:
        n *= 2
    return n


def causal_bias(q_len: int, kv_len: int, device=None) -> torch.Tensor:
    """(1, 1, q, kv) additive causal mask; query i may attend kv positions
    <= i."""
    qpos = torch.arange(q_len, device=device)[:, None]
    kpos = torch.arange(kv_len, device=device)[None, :]
    return torch.where(kpos <= qpos, 0.0, -1e30)[None, None]


def penalize(logits: torch.Tensor, seen: torch.Tensor, rp) -> torch.Tensor:
    """The repetition penalty on the ``seen`` ids: positive logits divided
    by ``rp``, the others multiplied by it (``rp`` a float, or a tensor
    that broadcasts against ``logits``)."""
    return torch.where(seen, torch.where(logits > 0, logits / rp, logits * rp), logits)


def draft_greedy(logits: torch.Tensor, seen: torch.Tensor, drafts: torch.Tensor,
                 rp) -> torch.Tensor:
    """Greedy-with-penalty at every row of speculative verify forwards:
    logits (B, d, V); seen (B, V); drafts (B, d - 1), the chunks' tokens
    after the first; rp a float or (B,) penalties. Row i penalizes seen ∪
    drafts[:, :i], the seen set at that position if the drafts before it
    are accepted. → (B, d) argmax ids."""
    B, d, V = logits.shape
    grew = torch.zeros((B, d, V), dtype=torch.int32, device=logits.device)
    if d > 1:
        grew[:, 1:].scatter_(2, drafts.long()[:, :, None], 1)
    rows = (torch.cumsum(grew, dim=1) > 0) | seen[:, None, :]
    if isinstance(rp, torch.Tensor):
        rows = rows & (rp != 1.0)[:, None, None]
        rp = rp[:, None, None]
    elif not rp or rp == 1.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(penalize(logits, rows, rp), dim=-1)


def init_decoder_params(cfg: LlamaConfig, generator: torch.Generator,
                        device=None, std: float = 0.02
                        ) -> Dict[str, torch.Tensor]:
    """Random weights drawn on ``device``: N(0, std) kernels, embeddings,
    routers and expert stacks, unit norms, zero biases (f32). With int8 or int4 quantization
    every kernel is quantized right after it is drawn, where it was drawn
    (an int8 expert stack one expert at a time; int4 experts are drawn one
    at a time), and the embeddings/lm_head are stored in bf16
    (``quantize_decoder_params``), so a model never exists in f32 at once;
    routers stay f32. ``head_quantization="int8"`` quantizes an untied
    lm_head per vocab column."""
    c = cfg
    hd = c.head_dim
    quant = c.quantization != "none"
    out: Dict[str, torch.Tensor] = {}

    def draw(*shape):
        return torch.empty(shape, device=device).normal_(0.0, std,
                                                         generator=generator)

    def kernel(name, i, o):
        w = draw(i, o)
        if c.quantization == "int4":
            out[f"{name}.kernel_p"], out[f"{name}.gscale"] = \
                quantize_int4_groupwise(w, group=c.int4_group or None)
        elif quant:
            out[f"{name}.kernel_q"], out[f"{name}.scale"] = quantize_kernel_int8(w)
        else:
            out[f"{name}.kernel"] = w

    def ones(name, n):
        out[name] = torch.ones(n, device=device)

    def zeros(name, n):
        out[name] = torch.zeros(n, device=device)

    emb_dtype = torch.bfloat16 if quant else torch.float32
    out["token_embedding"] = draw(c.vocab_size, c.hidden_size).to(emb_dtype)
    nq, nkv = c.num_heads * hd, c.num_kv_heads * hd
    for i in range(c.num_layers):
        p = f"layers.{i}"
        ones(f"{p}.input_norm.scale", c.hidden_size)
        a = f"{p}.attention"
        if c.fused_projections:
            kernel(f"{a}.qkv_proj", c.hidden_size, nq + 2 * nkv)
            if c.qkv_bias:
                zeros(f"{a}.qkv_proj.bias", nq + 2 * nkv)
        else:
            for name, n in (("q_proj", nq), ("k_proj", nkv), ("v_proj", nkv)):
                kernel(f"{a}.{name}", c.hidden_size, n)
                if c.qkv_bias:
                    zeros(f"{a}.{name}.bias", n)
        if c.qk_norm:
            ones(f"{a}.q_norm.scale", hd)
            ones(f"{a}.k_norm.scale", hd)
        kernel(f"{a}.o_proj", nq, c.hidden_size)
        ones(f"{p}.post_attn_norm.scale", c.hidden_size)
        if c.post_norms:
            ones(f"{p}.pre_ffw_norm.scale", c.hidden_size)
            ones(f"{p}.post_ffw_norm.scale", c.hidden_size)
        if c.is_moe_layer(i):
            out[f"{p}.mlp.router"] = draw(c.hidden_size, c.num_experts)
            f = c.moe_intermediate_size or c.intermediate_size
            for name, (fi, fo) in (("gate", (c.hidden_size, f)), ("up", (c.hidden_size, f)),
                                   ("down", (f, c.hidden_size))):
                if c.quantization == "int4":
                    out[f"{p}.mlp.{name}_p"], out[f"{p}.mlp.{name}_gs"] = quantize_experts_int4(
                        (draw(fi, fo) for _ in range(c.num_experts)), c.int4_group)
                    continue
                w = draw(c.num_experts, fi, fo)
                if quant:
                    out[f"{p}.mlp.{name}_q"], out[f"{p}.mlp.{name}_s"] = \
                        quantize_experts_int8(w)
                else:
                    out[f"{p}.mlp.{name}"] = w
                del w
            continue
        if c.fused_projections:
            kernel(f"{p}.mlp.gate_up_proj", c.hidden_size, 2 * c.intermediate_size)
        else:
            kernel(f"{p}.mlp.gate_proj", c.hidden_size, c.intermediate_size)
            kernel(f"{p}.mlp.up_proj", c.hidden_size, c.intermediate_size)
        kernel(f"{p}.mlp.down_proj", c.intermediate_size, c.hidden_size)
    ones("final_norm.scale", c.hidden_size)
    if not c.tie_embeddings:
        w = draw(c.hidden_size, c.vocab_size)
        if c.head_quantization == "int8":
            out["lm_head_q"], out["lm_head_scale"] = quantize_kernel_int8(w)
        else:
            out["lm_head"] = w.to(emb_dtype)
    return out


class _DoneFlag:
    """A device flag that the host reads without waiting for the device.
    Each ``poll`` returns the newest value that has reached pinned host
    memory and, once that copy has landed (an event not yet recorded
    counts as landed), queues the next one behind the event. On the CPU
    the flag is read directly."""

    def __init__(self, flag: torch.Tensor):
        self.flag = flag
        self.host = self.event = None
        if flag.device.type == "cuda":
            self.host = torch.zeros(flag.shape, dtype=flag.dtype, pin_memory=True)
            self.event = torch.cuda.Event()

    def poll(self) -> bool:
        if self.host is None:
            return bool(self.flag.any())
        if not self.event.query():
            return False
        if self.host.any():
            return True
        self.host.copy_(self.flag, non_blocking=True)
        self.event.record()
        return False


class LocalLLM:
    """Generation wrapper: prefill + stepwise decode with temperature
    sampling and repetition penalty."""

    PREFILL_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768)

    def __init__(self, cfg: LlamaConfig, tokenizer,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, eos_ids: Sequence[int] = (), device=None,
                 mesh=None):
        """``params``: a state dict (``init_decoder_params``,
        ``convert.flax_to_state_dict``); its tensors are adopted as they are
        (dtype and device). None draws ``init_decoder_params`` from
        ``seed`` on ``device``.

        ``mesh`` (``parallel.mesh.make_mesh``) with a model axis of D > 1,
        or a corpus axis of more than one device: tensor-parallel inference
        (``ShardedLlamaModel``) on the mesh's first device (``device`` is
        not read). num_kv_heads must be a multiple of D. ``params`` is then
        a state dict that ``parallel.tp.tp_shard_model`` shards (drawn on
        the first device when None), or its result, a list of the shards'
        state dicts. Generation is unchanged: the caches are held per
        shard, and the prefill rings over the corpus axis when it has more
        than one device."""
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.eos_ids = set(int(e) for e in eos_ids)
        self.mesh = None
        if sharded_mesh(mesh):
            from ragmeup_tpu_torch.parallel.tp import tp_shard_model
            assert cfg.num_kv_heads % mesh.shape["model"] == 0, (
                f"num_kv_heads={cfg.num_kv_heads} not divisible by model "
                f"axis {mesh.shape['model']}")
            self.mesh = mesh
            self.device = canonical(mesh.axis_devices("model")[0])
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
                params = init_decoder_params(cfg, gen, self.device)
            if not isinstance(params, list):
                params = tp_shard_model(params, cfg, mesh)
            self.model = ShardedLlamaModel(cfg, mesh, params)
            return
        self.device = resolve_device(device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_decoder_params(cfg, gen, self.device)
        with torch.device("meta"):
            model = LlamaModel(cfg)
        model.load_state_dict(params, strict=True, assign=True)
        # the rope table is not a weight: rebuild it where the weights live
        model.inv_freq = torch.from_numpy(
            rope_inv_freq(cfg.head_dim, cfg.rope_theta, cfg=cfg)).to(self.device)
        self.model = model.requires_grad_(False).eval()

    # -- prefill / decode -------------------------------------------------------

    def _prefill(self, ids: torch.Tensor, length: int, cache_len: int):
        """ids: (1, L) padded prompt; length: real prompt length. Returns
        (logits of the last real token (vocab,), caches of cache_len)."""
        L = ids.shape[1]
        dev = self.device
        kmask = torch.where(torch.arange(cache_len, device=dev) < length,
                            0.0, -1e30)[None, None, None, :]
        bias = causal_bias(L, cache_len, device=dev) + kmask
        caches = self.model.empty_caches(1, cache_len)
        logits = self.model(ids, torch.arange(L, device=dev), attn_bias=bias,
                            caches=caches, cache_pos=0, head_at=length - 1, ring=True)
        return logits[0, 0], caches

    def _decode(self, token, pos: int, caches):
        """One token (an int, or a (1,) tensor on the device) at absolute
        position ``pos`` against the cache."""
        if not isinstance(token, torch.Tensor):
            token = torch.tensor([token], device=self.device)
        return self._verify(token, pos, caches)[0]

    def _verify(self, chunk, p0: int, caches) -> torch.Tensor:
        """``chunk``'s tokens (ints, or a 1-D tensor on the device) at
        positions p0, p0 + 1, ... against the cache, their K/V written into
        it → (len(chunk), vocab) logits, row i the distribution after
        chunk[:i + 1]: a decode step, or a speculative verify forward."""
        dev = self.device
        ids = (chunk if isinstance(chunk, torch.Tensor)
               else torch.tensor(list(chunk), device=dev))[None]
        k0 = caches[0][0]
        kv_len = (k0[0] if isinstance(k0, list) else k0).shape[1]  # per-shard lists under a mesh
        positions = torch.arange(p0, p0 + ids.shape[1], device=dev)
        bias = torch.where(torch.arange(kv_len, device=dev)[None, :]
                           <= positions[:, None], 0.0, -1e30)[None, None]
        return self.model(ids, positions, attn_bias=bias, caches=caches,
                          cache_pos=p0)[0]

    def _bucket(self, n: int) -> int:
        for b in self.PREFILL_BUCKETS:
            if n <= b:
                return min(b, self.cfg.max_seq_len)
        return self.cfg.max_seq_len

    def _padded(self, ids: Sequence[int], L: int) -> torch.Tensor:
        padded = torch.zeros((1, L), dtype=torch.long)
        padded[0, :len(ids)] = torch.as_tensor(list(ids), dtype=torch.long)
        return padded.to(self.device)

    # -- public ------------------------------------------------------------------

    @torch.inference_mode()
    def forward_logits(self, ids: Sequence[int]) -> np.ndarray:
        """Logits after the last token of ``ids`` (tests/eval)."""
        L = self._bucket(len(ids))
        logits, _ = self._prefill(self._padded(ids, L), len(ids), cache_len=L)
        return logits.cpu().numpy()

    @torch.inference_mode()
    def attention_forward(self, ids: Sequence[int]) -> List[np.ndarray]:
        """Forward with attention capture (provenance): per layer the
        (1, heads, L, L) softmax weights over the unpadded ids, f32."""
        out = self._capture(ids, capture_weights=True)
        return [w.float().cpu().numpy() for w in out["attn_weights"]]

    @torch.inference_mode()
    def qk_forward(self, ids: Sequence[int]) -> Tuple[np.ndarray, np.ndarray]:
        """The last layer's post-RoPE (q, k), each (1, L, heads, hd) f32 (k
        repeated to the query heads): the inputs of blockwise attention
        provenance, which never builds the L×L matrix."""
        q, k = self._capture(ids, capture_qk_last=True)["qk_last"]
        return q.float().cpu().numpy(), k.float().cpu().numpy()

    def _capture(self, ids: Sequence[int], **capture) -> dict:
        L = len(ids)
        dev = self.device
        # the head only at the last row: the captures do not need logits
        return self.model(torch.tensor([list(ids)], device=dev),
                          torch.arange(L, device=dev),
                          attn_bias=causal_bias(L, L, device=dev),
                          head_at=L - 1, **capture)

    def _fit_prompt(self, prompt_ids: Sequence[int], max_new_tokens: int) -> List[int]:
        """The context-window guard: the prompt's tail, leaving room to
        generate."""
        msl = self.cfg.max_seq_len
        max_prompt = msl - min(max_new_tokens, msl // 2)
        return list(prompt_ids)[-max_prompt:]

    def _seen(self, ids: Sequence[int]) -> torch.Tensor:
        """(vocab,) bool on the device: the ids the repetition penalty hits."""
        seen = torch.zeros(self.cfg.vocab_size, dtype=torch.bool, device=self.device)
        if len(ids):
            seen[torch.as_tensor(sorted(set(map(int, ids))), device=self.device)] = True
        return seen

    @staticmethod
    def _pick(logits: torch.Tensor, seen: torch.Tensor, temperature: float,
              rp: float, gen: Optional[torch.Generator]) -> torch.Tensor:
        """The next token as a (1,) tensor on the device: the penalty on the
        seen ids, then a draw from softmax(logits / T) through ``gen``, or
        the argmax at T = 0."""
        if rp and rp != 1.0:
            logits = penalize(logits, seen, rp)
        if temperature and temperature > 0:
            return torch.multinomial(torch.softmax(logits / temperature, dim=-1), 1,
                                     generator=gen)
        return torch.argmax(logits).reshape(1)

    @torch.inference_mode()
    def generate(self, prompt_ids: Sequence[int], max_new_tokens: int = 100,
                 temperature: float = 0.2, repetition_penalty: float = 1.1,
                 seed: int = 0, fused: bool = True,
                 speculative: str = "auto") -> List[int]:
        """Continuation token ids (prompt not included): greedy at
        temperature 0, else sampled from softmax(logits / T) with a
        ``torch.Generator`` seeded by ``seed``.

        ``speculative="auto"`` with ``fused`` sends greedy requests through
        ``generate_speculative``; ``"off"`` keeps the one-token loop.
        ``fused`` keeps sampling, the penalty, EOS and the output on the
        device (the host learns of EOS without waiting, and reads the
        tokens once at the end); ``fused=False`` is the host loop that
        reads every token. Both loops draw from one generator in the same
        order, so for a seed they give the same tokens."""
        if (speculative == "auto" and fused
                and not (temperature and temperature > 0)):
            return self.generate_speculative(
                prompt_ids, max_new_tokens=max_new_tokens,
                repetition_penalty=repetition_penalty)
        prompt_ids = self._fit_prompt(prompt_ids, max_new_tokens)
        n = len(prompt_ids)
        cache_len = self._bucket(n + max_new_tokens)
        logits, caches = self._prefill(self._padded(prompt_ids, self._bucket(n)),
                                       n, cache_len=cache_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        loop = self._loop_fused if fused else self._loop_host
        return loop(logits, caches, n, cache_len, self._seen(prompt_ids), gen,
                    max_new_tokens, temperature, repetition_penalty)

    def _loop_host(self, logits, caches, n, cache_len, seen, gen, max_new,
                   temperature, rp) -> List[int]:
        out: List[int] = []
        pos = n
        for _ in range(max_new):
            tok = int(self._pick(logits, seen, temperature, rp, gen))
            if tok in self.eos_ids:
                break
            out.append(tok)
            seen[tok] = True
            logits = self._decode(tok, pos, caches)
            pos += 1
            if pos >= cache_len:
                break
        return out

    def _loop_fused(self, logits, caches, n, cache_len, seen, gen, max_new,
                    temperature, rp) -> List[int]:
        """The host loop's tokens without a read that waits: (done, count)
        live on the device, and the host learns of EOS through
        ``_DoneFlag``, which never blocks. A step after EOS, run while the
        news is on its way (as long as the device lags the host), is
        masked, as a done row of a wave is: it emits nothing, marks nothing
        seen and feeds token 0."""
        dev = self.device
        eos = torch.tensor(sorted(self.eos_ids) or [-1], device=dev)
        out = torch.full((max_new,), -1, dtype=torch.long, device=dev)
        state = torch.zeros(2, dtype=torch.long, device=dev)  # done, count
        flag = _DoneFlag(state[:1])
        pos = n
        for step in range(max_new):
            tok = self._pick(logits, seen, temperature, rp, gen)
            emit = (state[:1] == 0) & ~(tok == eos).any()
            out[step:step + 1] = torch.where(emit, tok, -1)
            seen[tok] = seen[tok] | emit
            state += torch.cat([~emit, emit]).long()
            if step == max_new - 1 or flag.poll():
                break
            logits = self._decode(torch.where(emit, tok, 0), pos, caches)
            pos += 1
            if pos >= cache_len:
                break
        return out[:int(state[1])].tolist()

    @torch.inference_mode()
    def generate_speculative(self, prompt_ids: Sequence[int],
                             max_new_tokens: int = 100,
                             repetition_penalty: float = 1.1,
                             draft_len: int = 8, return_stats: bool = False):
        """Greedy generation with self-speculative decoding: the tokens of
        ``generate(temperature=0, speculative="off")``, up to ``draft_len``
        a forward where the continuation repeats a 2-gram of the context
        (RAG answers quote their documents).

        One iteration: the last 2-gram match whose continuation window is
        confirmed gives d - 1 draft tokens; one verify forward of [pending,
        drafts] against the dense cache at offset p0; greedy-with-penalty
        at every row; the drafts accepted while they equal it, then the
        model's own next token. The host reads the d greedy ids once a
        verify forward (one sync a forward, not a token) and keeps the
        token buffer, so the cache is written at a host offset. The cache
        is never written past its end: near it the chunk narrows, and the
        stream stops where the window ends, as the plain loop does.
        ``return_stats`` adds {"iters": verify forwards, "accepted": draft
        tokens accepted}."""
        prompt_ids = self._fit_prompt(prompt_ids, max_new_tokens)
        n = len(prompt_ids)
        d = draft_len
        rp = repetition_penalty
        cache_len = self._bucket(n + max_new_tokens + d)
        logits, caches = self._prefill(self._padded(prompt_ids, self._bucket(n)),
                                       n, cache_len=cache_len)
        stats = {"iters": 0, "accepted": 0}
        seen = self._seen(prompt_ids)
        t0 = int(self._pick(logits, seen, 0.0, rp, None))
        if t0 in self.eos_ids or max_new_tokens < 1:
            return ([], stats) if return_stats else []
        # confirmed tokens; buf[n_tok - 1] is pending: not yet in the cache
        buf = np.full(cache_len, -1, np.int64)
        buf[:n] = prompt_ids
        buf[n] = t0
        n_tok = n + 1
        seen[t0] = True
        left = max_new_tokens - 1
        while left > 0 and n_tok < cache_len:
            p0 = n_tok - 1
            pending, t1 = buf[p0], buf[max(p0 - 1, 0)]
            lim = max(n_tok - d, 0)  # matches j <= n_tok - d - 1
            hits = np.flatnonzero((buf[:lim] == t1) & (buf[1:lim + 1] == pending))
            cont = (buf[hits[-1] + 2:hits[-1] + d + 1] if len(hits)
                    else np.zeros(d - 1, np.int64))
            w = min(d, cache_len - p0)
            chunk = [int(pending)] + [int(t) for t in cont[:w - 1]]
            lg = self._verify(chunk, p0, caches)
            greedy = draft_greedy(lg[None], seen[None],
                                  torch.tensor([chunk[1:]], device=self.device),
                                  rp)[0].tolist()
            a = 0
            while a < w - 1 and chunk[a + 1] == greedy[a]:
                a += 1
            toks = chunk[1:a + 1] + [greedy[a]]
            first_eos = next((i for i, t in enumerate(toks) if t in self.eos_ids),
                             len(toks))
            emit = min(a + 1, first_eos, left, cache_len - n_tok)
            buf[n_tok:n_tok + emit] = toks[:emit]
            if emit:
                seen[torch.tensor(toks[:emit], device=self.device)] = True
            n_tok += emit
            left -= emit
            stats["iters"] += 1
            stats["accepted"] += a
            if first_eos <= a or emit == 0:
                break
        out = [int(t) for t in buf[n:n_tok]]
        return (out, stats) if return_stats else out

    def generate_text(self, prompt: str, max_new_tokens: int = 100,
                      temperature: float = 0.2, repetition_penalty: float = 1.1,
                      seed: int = 0) -> str:
        ids = self.tokenizer.encode(prompt)
        out = self.generate(ids, max_new_tokens, temperature,
                            repetition_penalty, seed)
        if hasattr(self.tokenizer, "decode"):
            return self.tokenizer.decode(out)
        return " ".join(str(t) for t in out)
