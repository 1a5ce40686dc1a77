"""Build, load and count the port's hand-written CUDA kernels.

The sources under ``ragmeup_tpu_torch/csrc/`` compile with ``nvcc`` (one
process per source, all started together) and link into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds),
which ``ctypes`` loads. The library is built at first use
into ``build/`` at the repository root, named by a hash of every file under
``csrc/`` (sources and the headers they include) and the flags, so an edited
source or header never loads a stale build. Nothing here runs when
the module is imported: machines without ``nvcc`` or a card import the
package and use the plain PyTorch versions for CPU tensors.

Each op wrapper calls :func:`count` once per launch of its kernel, so a run
can show that the main path really went through the kernels
(:func:`reset_counts` / :func:`launch_counts`). Inside
:func:`shard_scope` (a shard of the model axis running its part of a
layer) a launch also counts under its shard (:func:`shard_counts`).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "ragmeup_tpu_torch")
SOURCES = ("topk.cu", "quant_matmul.cu", "quant_matmul_int4.cu",
           "flash_attention.cu", "paged_attention.cu", "moe_matmul.cu",
           "moe_stack.cu", "moe_wgrad.cu", "moe_matmul_int4.cu", "fused_mlp_int4.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

KERNELS = ("topk", "int8_matmul", "flash_gqa", "topk_int8", "int4_matmul",
           "int4_matmul_a8", "paged_attention", "paged_attention_chunk",
           "moe_gather", "moe_grouped", "moe_grouped_stack", "moe_gather_int4",
           "moe_grouped_int4", "fused_mlp_int4", "moe_grouped_wgrad")

_lock = threading.Lock()
_tickets_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_counts: Dict[str, int] = {name: 0 for name in KERNELS}
_variants: Dict[str, int] = {}
_by_shard: Dict[str, int] = {}
_scope = threading.local()  # .shard: the model-axis shard launching, or None
build_log = ""  # nvcc's output of the last build (ptxas register/smem report)


def count(name: str, variant: Optional[str] = None) -> None:
    """Record one launch of kernel ``name``; ``variant`` (a shape the kernel
    is instantiated or laid out for, such as ``"hd=256 g=2"``) also counts
    it under ``"name variant"`` in :func:`variant_counts`."""
    _counts[name] += 1
    if variant is not None:
        key = f"{name} {variant}"
        _variants[key] = _variants.get(key, 0) + 1
    shard = getattr(_scope, "shard", None)
    if shard is not None:
        key = f"{name} shard={shard}"
        _by_shard[key] = _by_shard.get(key, 0) + 1


@contextlib.contextmanager
def shard_scope(index: int):
    """Count this thread's launches under model-axis shard ``index`` too."""
    prev = getattr(_scope, "shard", None)
    _scope.shard = index
    try:
        yield
    finally:
        _scope.shard = prev


def reset_counts() -> None:
    for name in _counts:
        _counts[name] = 0
    _variants.clear()
    _by_shard.clear()


def shard_counts() -> Dict[str, int]:
    """Launches by kernel and model-axis shard ("name shard=i") since the
    last reset."""
    return dict(_by_shard)


def launch_counts() -> Dict[str, int]:
    return dict(_counts)


def variant_counts() -> Dict[str, int]:
    """Launches by kernel and variant since the last reset."""
    return dict(_variants)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh", ".h")):
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"librk_kernels-{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels (if this exact source set is not built yet) and
    return the library's path."""
    global build_log
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}"
    objs = [f"{tmp}.{name}.o" for name in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                               os.path.join(CSRC, name)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for name, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [(name, proc.returncode, log) for name, proc, log
              in zip(SOURCES, procs, logs) if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.so", *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            failed = [("link", link.returncode, link.stdout + link.stderr)]
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"{name} ({rc}):\n{log}" for name, rc, log in failed))
    os.replace(f"{tmp}.so", path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(build())
            vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            so.rk_topk.argtypes = [vp, vp, i32, vp, i32, i32, i32, i32, i32, i32,
                                   vp, vp, vp, vp, vp, vp]
            so.rk_topk.restype = i32
            so.rk_topk_int8.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                        vp, vp, vp, vp, vp, vp]
            so.rk_topk_int8.restype = i32
            so.rk_int8_matmul.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                          vp, vp, vp]
            so.rk_int8_matmul.restype = i32
            so.rk_int4_matmul.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                          i32, i32, vp, vp, vp]
            so.rk_int4_matmul.restype = i32
            so.rk_int4_decode.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                          i32, i32, i32, vp, vp, vp]
            so.rk_int4_decode.restype = i32
            so.rk_int4_matmul_a8.argtypes = [vp, vp, vp, i32, i32, i32, i32,
                                             i32, i32, vp, vp, vp, vp, vp]
            so.rk_int4_matmul_a8.restype = i32
            so.rk_int4_a8_decode.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                             i32, vp, vp, vp, vp, vp]
            so.rk_int4_a8_decode.restype = i32
            so.rk_quantize_rows.argtypes = [vp, i32, i32, i32, vp, vp, vp]
            so.rk_quantize_rows.restype = i32
            so.rk_flash_gqa.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32,
                                        f32, i32, i32, vp, vp, vp, vp]
            so.rk_flash_gqa.restype = i32
            so.rk_paged_attention.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                              i32, i32, i32, i32, i32, f32, i32, f32,
                                              i32, i32, vp, vp, vp]
            so.rk_paged_attention.restype = i32
            so.rk_moe_gather.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                         i32, vp, vp, vp, vp]
            so.rk_moe_gather.restype = i32
            so.rk_moe_grouped_rows.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32, i32,
                                               i32, vp, vp, vp, vp]
            so.rk_moe_grouped_rows.restype = i32
            so.rk_moe_grouped.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                          i32, vp, vp]
            so.rk_moe_grouped.restype = i32
            so.rk_moe_grouped_stack.argtypes = [vp, vp, vp, vp, vp, vp, i32, i32, i32,
                                                i32, vp, vp]
            so.rk_moe_grouped_stack.restype = i32
            so.rk_moe_grouped_stack_t.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32, i32,
                                                  vp, vp]
            so.rk_moe_grouped_stack_t.restype = i32
            so.rk_moe_grouped_wgrad.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, i32,
                                                vp, vp]
            so.rk_moe_grouped_wgrad.restype = i32
            so.rk_moe_gather_int4.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                              i32, i32, i32, vp, vp, vp]
            so.rk_moe_gather_int4.restype = i32
            so.rk_moe_gather_int4_decode.argtypes = [vp, vp, vp, vp, i32, i32, i32, i32,
                                                     i32, i32, i32, i32, vp, vp, vp]
            so.rk_moe_gather_int4_decode.restype = i32
            so.rk_moe_grouped_int4.argtypes = [vp, vp, vp, vp, vp, i32, i32, i32,
                                               i32, i32, i32, i32, vp, vp, vp]
            so.rk_moe_grouped_int4.restype = i32
            so.rk_fused_mlp_int4.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, i32,
                                             i32, i32, i32, i32, i32, i32, f32,
                                             i32, i32, i32, i32, vp, vp, vp, vp,
                                             vp, vp]
            so.rk_fused_mlp_int4.restype = i32
            so.rk_error_string.argtypes = [i32]
            so.rk_error_string.restype = ctypes.c_char_p
            _lib = so
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if err != 0:
        msg = lib().rk_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]


def stream_handle(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """SMs of the card the kernels launch on (the split plans read it)."""
    import torch
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def ticket_words(held: dict, device, words: int):
    """At least ``words`` zeroed int32 words on ``device`` for the current
    stream, from ``held`` ((device index, stream) -> buffers). A kernel's
    last-block route takes atomic tickets from them and leaves them zero;
    calls on one stream run in order, so no two launches share a word at
    once. Outgrown buffers stay referenced: a captured CUDA graph may still
    point at them. Threads of a server share the stream and the buffers; the
    lock keeps two of them from growing one at once (a thread would
    otherwise get the other's smaller buffer)."""
    import torch
    with _tickets_lock:
        bufs = held.setdefault((device.index, stream_handle(device)), [])
        if not bufs or bufs[-1].numel() < words:
            bufs.append(torch.zeros(max(words, 64), dtype=torch.int32, device=device))
        return bufs[-1]


def require_cuda(name: str, *tensors) -> None:
    """Shape-independent checks every wrapper makes before a launch. A
    kernel's output has no autograd edge, so a launch that a gradient
    would have to pass through raises instead of detaching it (the grouped
    GEMM's ``GroupedKernelPath`` launches with autograd off)."""
    import torch
    dev = tensors[0].device
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; call it under "
                           f"torch.no_grad() or on tensors that need no gradient")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: tensors must be 16-byte aligned")
