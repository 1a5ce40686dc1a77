"""W8A16 matmul for decode: the CUDA kernel and its plain version.

Counterpart of ``ragmeup_tpu/ops/quant_matmul.py::int8_matmul``:
``x (m, k) @ (w_q (k, n) int8 · scale (n,)) → (m, n)`` in x's dtype, f32
accumulation, the per-channel scale applied after the sum. At decode (m ≤ 8)
the product is bound by reading the int8 weights once; csrc/quant_matmul.cu
streams them with a deterministic split-K (see its header).
"""

from __future__ import annotations

import functools

import torch

from ragmeup_tpu_torch import kernels

MAX_ROWS = 8
_COLS_PER_BLOCK = 512   # csrc/quant_matmul.cu: 128 threads x 4 columns


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: f32 product, scale, cast."""
    acc = x.float() @ w_q.float()
    return (acc * scale.float()[None, :]).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _target_blocks(device_index: int) -> int:
    """Two blocks per SM of the card the kernel launches on."""
    return 2 * torch.cuda.get_device_properties(device_index).multi_processor_count


def k_slice_for(k: int, n: int, target_blocks: int) -> int:
    """Split-K slice length: the longest slice (fewest partials) that still
    gives ``target_blocks`` blocks; a divisor of k."""
    col_blocks = -(-n // _COLS_PER_BLOCK)
    divisors = [s for s in (256, 128, 64, 32, 16) if k % s == 0]
    if not divisors:
        raise ValueError(f"int8_matmul kernel: k={k} not a multiple of 16")
    for s in divisors:
        if col_blocks * (k // s) >= target_blocks:
            return s
    return divisors[-1]


def _int8_matmul_cuda(x, w_q, scale):
    m, k = x.shape
    n = w_q.shape[1]
    if m > MAX_ROWS:
        raise ValueError(f"int8_matmul kernel takes at most {MAX_ROWS} rows, got {m}")
    if w_q.dtype != torch.int8 or n % 4:
        raise ValueError(f"int8_matmul kernel: w_q int8 with n % 4 == 0 "
                         f"(got {w_q.dtype}, n={n})")
    x = x.contiguous()
    scale = scale.float().contiguous()
    kernels.require_cuda("int8_matmul", x, w_q, scale)
    ks = k_slice_for(k, n, _target_blocks(x.device.index))
    partial = torch.empty((k // ks, m, n), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    err = kernels.lib().rk_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), m, k, n, ks,
        kernels.dtype_code(x.dtype), partial.data_ptr(), out.data_ptr(),
        kernels.stream_handle(x.device))
    kernels.check(err, "int8_matmul")
    kernels.count("int8_matmul")
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor
                ) -> torch.Tensor:
    """x (m, k) bf16/f32 @ (w_q (k, n) int8 · scale (n,)) → (m, n) x.dtype.

    CUDA tensors launch the kernel (m ≤ 8); CPU tensors take the plain
    version."""
    if x.shape[1] != w_q.shape[0] or scale.numel() != w_q.shape[1]:
        raise ValueError(f"int8_matmul shapes: x {tuple(x.shape)}, "
                         f"w {tuple(w_q.shape)}, scale {tuple(scale.shape)}")
    if x.is_cuda:
        return _int8_matmul_cuda(x, w_q, scale)
    return int8_matmul_plain(x, w_q, scale)
