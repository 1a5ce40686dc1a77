"""The attention kernels #8 and #9 timed on one card at the shapes of the
checkpoint families, beside their bounds and SDPA.

    python3 ragmeup_tpu_torch/tools/attention_times.py [--tree DIR] [--sweep]

Imports ``ragmeup_tpu_torch`` from the checkout at DIR (by default the one
that holds this file), draws N(0, 1) bf16 inputs (seed 0) on the card, and
prints the card's name and power limit, then one JSON line. Every time is
the device time of one call, from a CUDA graph's replay (median of five
rounds after warm-up rounds until two agree within 5 %):

- ``flash``: ``flash_attention_gqa`` (#8), causal, s 1024, kv_len 2048, at
  Gemma-7B's prefill (hd 256, 16 kv heads, g 1), Gemma-2-9B's (hd 256, 8 kv
  heads, g 2), a Gemma-2B-shaped one (hd 256, 1 kv head, g 8) and the 8B's
  (hd 128, 8 kv heads, g 4): ``graph_ms``, ``sdpa_ms``
  (``scaled_dot_product_attention`` on the same inputs, which the port
  never calls), ``bound_ms`` (bytes or operations, as chip_smoke.py's
  ``bound``) and the largest error against the plain version; at hd 256,
  where the tree has the split plan, ``split_q_blocks`` and
  ``graph_ms_no_split`` (the plan made to split nothing);
- ``decode``: ``paged_attention`` (#9, q_len 1) over 128-token pages with
  16-page tables, 8 sequences of [1, 2048, 777, 128, 129, 1500, 64, 1024]
  tokens, at Gemma-2-9B's heads (16/8, hd 256, softcap 50, scale 1/16),
  Gemma-7B's (16/16, hd 256), the 8B's (32/8, hd 128), Phi-3-mini's
  (32/32, hd 96) and Qwen2.5-0.5B's (14/2, hd 64): ``graph_ms``,
  ``splits``, ``bound_ms``, the error against the plain version and
  ``replays_equal`` (one call captured in a graph and replayed twice: the
  outputs equal bit for bit);
- ``chunk``: ``paged_attention_chunk`` at Gemma-2-9B's heads, a 128-token
  chunk for 4 sequences after 0 to 1920 tokens (``Gemma-2-9B``) and the
  spec waves' 8-token chunk for 4 sequences after 300 to 2040 tokens
  (``Gemma-2-9B q8``), each with ``replays_equal``;
- with ``--sweep``: the hd-256, hd-96 and hd-64 decode rows again for each
  decode target of blocks an SM the split plan may aim at (``sweep``), and
  the two chunk rows for each chunk target (``chunk_sweep``);
- with ``--stream``: ``stream_graph_ms``, a stream-only copy of the hd-64-128
  decode kernel's loads (its grid, split plan, 64-key tiles through a
  cp.async ring of rows padded by 16 bytes, one barrier a tile, no
  arithmetic) at the hd-96 and hd-64 decode rows, with two stages (the
  rk_paged_decode_kernel ring) and three (the rk_paged_decode_narrow_kernel
  ring): how fast the loads alone run.

To compare a parent commit on one card, unpack ``git archive <parent>`` into
``build/parent`` and run the tool in one command in the order parent,
change, change, parent (``--tree build/parent`` for the parent's runs).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
LENGTHS = [1, 2048, 777, 128, 129, 1500, 64, 1024]
# (label, head dim, query heads, kv heads, extra arguments)
FLASH = (("Gemma-7B", 256, 16, 16), ("Gemma-2-9B", 256, 16, 8), ("Gemma-2B", 256, 8, 1),
         ("8B", 128, 32, 8))
GEMMA2 = {"softcap": 50.0, "sm_scale": 1 / 16}
DECODE = (("Gemma-2-9B", 256, 16, 8, GEMMA2), ("Gemma-7B", 256, 16, 16, {}),
          ("8B", 128, 32, 8, {}), ("Phi-3-mini", 96, 32, 32, {}),
          ("Qwen2.5-0.5B", 64, 14, 2, {}))
SPEC_PREFIXES = (300, 777, 1500, 2040)

STREAM_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
// The hd-64-128 decode kernel's loads alone: grid (split, kv head,
// sequence), 128 threads, 64-key K and V tiles of a 128-token-page pool
// through a STAGES-deep cp.async ring of rows padded by 16 bytes, keys
// outside the split's [a, e) zero-filled, one barrier a tile.
template <int HD, int STAGES>
__global__ void __launch_bounds__(128) stream_decode(const uint16_t* __restrict__ k_pages,
    const uint16_t* __restrict__ v_pages, const int* __restrict__ page_idx,
    const int* __restrict__ lengths, int P, int ps, int mp, int kps, int* __restrict__ sink) {
  constexpr int kLd = HD + 8, kSeg = HD / 8, kTile = 64 * kLd;
  extern __shared__ __align__(16) uint16_t ring[];
  const int split = blockIdx.x, kvh = blockIdx.y, bi = blockIdx.z, tid = threadIdx.x;
  const int length = lengths[bi];
  const int* table = page_idx + (size_t)bi * mp;
  const int a = split * kps, e = min(min(a + kps, mp * ps), length);
  if (a >= e) return;
  const size_t plane = (size_t)kvh * P * ps * HD;
  const int t0 = a / 64, t1 = (e + 63) / 64;
  auto load = [&](int t) {
    if (t < t1) {
      uint16_t* kd = ring + ((t - t0) % STAGES) * 2 * kTile;
      const int key0 = t * 64, base = table[key0 / ps] * ps + key0 % ps;
      for (int i = tid; i < 64 * kSeg; i += 128) {
        const int c = i / kSeg, seg = i % kSeg, key = key0 + c;
        const bool ok = key >= a && key < e;
        const size_t off = plane + (size_t)(ok ? base + c : 0) * HD + seg * 8;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"((uint32_t)__cvta_generic_to_shared(kd + c * kLd + seg * 8)),
                     "l"(k_pages + off), "r"(ok ? 16 : 0) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                     "r"((uint32_t)__cvta_generic_to_shared(kd + kTile + c * kLd + seg * 8)),
                     "l"(v_pages + off), "r"(ok ? 16 : 0) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int i = 0; i < STAGES - 1; ++i) load(t0 + i);
  int acc = 0;
  for (int t = t0; t < t1; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    load(t + STAGES - 1);
    acc ^= ring[((t - t0) % STAGES) * 2 * kTile + tid];
  }
  if (acc == 0x7fffffff) sink[tid] = acc;
}
template <int HD, int STAGES>
int launch(const void* k, const void* v, const int* idx, const int* lens, int b, int nkv, int P,
           int ps, int mp, int kps, int* sink, void* stream) {
  const int smem = STAGES * 2 * 64 * (HD + 8) * 2;
  cudaFuncSetAttribute(stream_decode<HD, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  const int splits = (mp * ps + kps - 1) / kps;
  stream_decode<HD, STAGES><<<dim3(splits, nkv, b), 128, smem, (cudaStream_t)stream>>>(
      (const uint16_t*)k, (const uint16_t*)v, idx, lens, P, ps, mp, kps, sink);
  return (int)cudaGetLastError();
}
extern "C" int stream_decode_launch(const void* k, const void* v, const int* idx,
                                    const int* lens, int b, int nkv, int P, int ps, int mp,
                                    int hd, int stages, int kps, int* sink, void* stream) {
  if (hd == 96) return stages == 2 ? launch<96, 2>(k, v, idx, lens, b, nkv, P, ps, mp, kps, sink, stream)
                                   : launch<96, 3>(k, v, idx, lens, b, nkv, P, ps, mp, kps, sink, stream);
  return stages == 2 ? launch<64, 2>(k, v, idx, lens, b, nkv, P, ps, mp, kps, sink, stream)
                     : launch<64, 3>(k, v, idx, lens, b, nkv, P, ps, mp, kps, sink, stream);
}
"""
SWEEP = (2, 3, 4, 6, 8, 12, 16)
CHUNK_SWEEP = (1, 2, 3, 4)


def stream_times(pa, decode_inputs) -> dict:
    """The decode loads alone (STREAM_SOURCE) at the hd-96 and hd-64 decode
    rows, under the split plan of the tree timed, two and three stages."""
    import ctypes
    import torch
    from ragmeup_tpu_torch import kernels
    out_dir = os.path.join(os.path.dirname(kernels.library_path()), "paged_stream")
    os.makedirs(out_dir, exist_ok=True)
    src, so = os.path.join(out_dir, "paged_stream.cu"), os.path.join(out_dir, "libstream.so")
    with open(src, "w") as f:
        f.write(STREAM_SOURCE)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.stream_decode_launch.argtypes = [vp, vp, vp, vp] + [i32] * 8 + [vp, vp]
    sink = torch.zeros(128, dtype=torch.int32, device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, hd, nh, nkv, _ in DECODE:
        if hd not in (64, 96):
            continue
        _, k, v, idx, lens = decode_inputs[label]
        b, mp = idx.shape
        P, ps = k.shape[1], k.shape[2]
        kps = pa.kernel_split(b, 1, nh, nkv, ps, mp, torch.bfloat16, sms, hd)
        for stages in (2, 3):
            out[f"{label} stages={stages}"] = graph_ms(lambda: lib.stream_decode_launch(
                k.data_ptr(), v.data_ptr(), idx.data_ptr(), lens.data_ptr(), b, nkv, P, ps, mp,
                hd, stages, kps, sink.data_ptr(), torch.cuda.current_stream().cuda_stream))
    return out


def graph_ms(fn, reps: int = 10, rounds: int = 5, warm_rounds: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()

    def one_round() -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    last = one_round()
    for _ in range(warm_rounds - 1):
        now = one_round()
        if abs(now - last) <= 0.05 * last:
            break
        last = now
    return statistics.median(one_round() for _ in range(rounds))


def bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3


def flash_rows(attention, gen) -> dict:
    import torch
    rows = {}
    for label, hd, nh, nkv in FLASH:
        g, s, kv_len = nh // nkv, 1024, 2048
        q = torch.randn(nkv, g, s, hd, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(nkv, kv_len, hd, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(nkv, kv_len, hd, generator=gen, device="cuda").to(torch.bfloat16)
        kq, vq = k[:, None, :s], v[:, None, :s]
        err = (attention.flash_attention_gqa(q, k, v).float()
               - attention.flash_attention_gqa_plain(q, k, v).float()).abs().max().item()
        pairs = nkv * g * s * (s + 1) // 2
        rows[label] = {
            "graph_ms": graph_ms(lambda: attention.flash_attention_gqa(q, k, v)),
            "sdpa_ms": graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                q, kq, vq, is_causal=True, enable_gqa=True)),
            "bound_ms": bound_ms(2 * 2 * q.numel() + 2 * 2 * kq.numel(), 4 * pairs * hd),
            "max_abs_err": err, "shape": f"bkv={nkv} g={g} s={s} kv_len={kv_len} hd={hd}"}
        plan = getattr(attention, "wgmma_split_from", None)
        if hd == 256 and plan is not None:
            nq = -(-s // (attention.WGMMA_ROWS // g))
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            rows[label]["split_q_blocks"] = nq - plan(nkv, g, s, kv_len, sms)
            attention.wgmma_split_from = lambda *args: nq
            try:
                rows[label]["graph_ms_no_split"] = graph_ms(
                    lambda: attention.flash_attention_gqa(q, k, v))
            finally:
                attention.wgmma_split_from = plan
    return rows


def paged_inputs(gen, b, lengths, q_len, nh, nkv, hd, P=512, ps=128, mp=16):
    import torch
    q = torch.randn(b, q_len, nh, hd, generator=gen, device="cuda").to(torch.bfloat16)
    k = torch.randn(nkv, P, ps, hd, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(nkv, P, ps, hd, generator=gen, device="cuda").to(torch.bfloat16)
    idx = torch.randperm(P, generator=gen, device="cuda")[:b * mp].reshape(b, mp)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q[:, 0].contiguous() if q_len == 1 else q, k, v, idx.to(torch.int32), lens


def paged_row(pa, inputs, hd, nh, nkv, kw, chunk=False) -> dict:
    import torch
    q, k, v, idx, lens = inputs
    fn = pa.paged_attention_chunk if chunk else pa.paged_attention
    plain = pa.paged_attention_chunk_plain if chunk else pa.paged_attention_plain
    err = (fn(q, k, v, idx, lens, **kw).float()
           - plain(q, k, v, idx, lens, **kw).float()).abs().max().item()
    q_len = q.shape[1] if chunk else 1
    b, mp = idx.shape
    lengths = lens.tolist()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    try:   # a tree whose plan does not take the head dim
        kps = pa.kernel_split(b, q_len, nh, nkv, 128, mp, torch.bfloat16, sms, hd)
    except TypeError:
        kps = pa.kernel_split(b, q_len, nh, nkv, 128, mp, torch.bfloat16, sms)
    pairs = sum(q_len * (n - q_len) + q_len * (q_len + 1) // 2 for n in lengths)
    row = {"graph_ms": graph_ms(lambda: fn(q, k, v, idx, lens, **kw)),
           "splits": pa.paged_splits(mp, 128, kps),
           "bound_ms": bound_ms(2 * sum(lengths) * nkv * hd * 2 + 2 * 2 * q.numel()
                                + 4 * (idx.numel() + lens.numel()), 4 * pairs * nh * hd),
           "max_abs_err": err}
    out = torch.empty_like(q)
    graph = torch.cuda.CUDAGraph()
    fn(q, k, v, idx, lens, **kw)
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out.copy_(fn(q, k, v, idx, lens, **kw))
    graph.replay()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    row["replays_equal"] = bool(torch.equal(first, out))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="checkout whose ragmeup_tpu_torch is timed")
    ap.add_argument("--sweep", action="store_true",
                    help="also time hd-256, hd-96 and hd-64 decode at each plan target")
    ap.add_argument("--stream", action="store_true",
                    help="also time the hd-96 and hd-64 decode loads alone")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from ragmeup_tpu_torch import kernels
    from ragmeup_tpu_torch.ops import attention
    from ragmeup_tpu_torch.ops import paged_attention as pa
    if os.path.dirname(os.path.dirname(os.path.abspath(pa.__file__))) != \
            os.path.join(tree, "ragmeup_tpu_torch"):
        raise SystemExit(f"attention_times: imported {pa.__file__}, not {tree}'s")
    if not torch.cuda.is_available():
        raise SystemExit("attention_times: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.lib()
    ptxas, fn = {}, "?"
    for line in kernels.build_log.splitlines():   # nvcc's -Xptxas -v report, where built
        if "Compiling entry function" in line or "Function properties for" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif ("registers" in line or "spill" in line) and ("flash" in fn or "paged" in fn):
            ptxas.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"tree": tree, "flash": flash_rows(attention, gen), "decode": {}}
    decode_inputs = {}
    for label, hd, nh, nkv, kw in DECODE:
        decode_inputs[label] = paged_inputs(gen, 8, LENGTHS, 1, nh, nkv, hd)
        result["decode"][label] = paged_row(pa, decode_inputs[label], hd, nh, nkv, kw)
    chunk_in = paged_inputs(gen, 4, [p + 128 for p in (0, 640, 1333, 1920)], 128, 16, 8, 256)
    spec_in = paged_inputs(gen, 4, [p + 8 for p in SPEC_PREFIXES], 8, 16, 8, 256)
    result["chunk"] = {"Gemma-2-9B": paged_row(pa, chunk_in, 256, 16, 8, GEMMA2, chunk=True),
                       "Gemma-2-9B q8": paged_row(pa, spec_in, 256, 16, 8, GEMMA2, chunk=True)}
    if args.sweep:
        result["sweep"] = {}
        held = pa._DECODE_BLOCKS_PER_SM
        try:
            for target in SWEEP:
                # a tree whose target is one number, or one a head dim
                pa._DECODE_BLOCKS_PER_SM = (target if isinstance(held, int)
                                            else {hd: target for hd in pa.KERNEL_HEAD_DIMS})
                result["sweep"][target] = {
                    label: paged_row(pa, decode_inputs[label], hd, nh, nkv, kw)
                    for label, hd, nh, nkv, kw in DECODE if hd != 128}
        finally:
            pa._DECODE_BLOCKS_PER_SM = held
        result["chunk_sweep"] = {}
        held = pa._CHUNK_BLOCKS_PER_SM
        try:
            for target in CHUNK_SWEEP:
                pa._CHUNK_BLOCKS_PER_SM = target
                result["chunk_sweep"][target] = {
                    label: paged_row(pa, inputs, 256, 16, 8, GEMMA2, chunk=True)
                    for label, inputs in (("Gemma-2-9B", chunk_in), ("Gemma-2-9B q8", spec_in))}
        finally:
            pa._CHUNK_BLOCKS_PER_SM = held
    if args.stream:
        result["stream_graph_ms"] = stream_times(pa, decode_inputs)
    result["ptxas"] = ptxas
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
