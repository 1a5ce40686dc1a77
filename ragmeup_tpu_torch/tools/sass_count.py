"""Instructions per packed byte in the int4 decode kernels' SASS, and per
int8 weight in #12's.

    python3 -m ragmeup_tpu_torch.tools.sass_count

Builds the kernel library (``kernels.build()``), disassembles it with
``cuobjdump -sass`` and counts, for each instantiation of
``rk_int4_decode_kernel`` (csrc/quant_matmul_int4.cu: activation type,
rows M, batch, route) and of ``rk_int4_decode_mma_kernel`` (bf16, by
route), of the expert gather's kernels on their bodies
(``rk_moe_gather_int4_decode_kernel``, ``rk_moe_gather_int4_mma_kernel``),
of the fused int4 MLP's kernels on the same stream
(``rk_mlp4_gate_up_mma_kernel``, ``rk_mlp4_down_mma_kernel``,
csrc/fused_mlp_int4.cu) and of the W4A8 decode kernel
``rk_int4_a8_decode_kernel``, the
instructions of its code by opcode. Every packed byte a W4A16 kernel
consumes passes through exactly one bf16 HADD2/HFMA2 (``nibbles_bf16x2``
turns the two nibbles at one position of two packed rows into bf16
integers: one per packed byte); every IMMA of the W4A8 kernel (an
m16n8k32 s8 mma: 16 columns x 16 packed rows a warp) consumes 8 packed
bytes a lane. #12's full-stack kernel ``rk_moe_stack_wgmma_kernel``
(csrc/moe_stack.cu) turns two int8 weights into bf16 with each bf16
HADD2 (``s8x2_bf16x2``), so its bytes are two a pair; its wgmmas (HGMMA)
are counted too. Conversions (I2F, I2FP, F2F, F2FP, F2I), all instructions,
PRMTs and LOP3s per packed byte follow from those counts. The counts are
static (each instruction of the code once, wherever a loop runs it), for
the whole kernel and for its main loop (the backward branch whose body
holds the most of those HADD2/HFMA2s or IMMAs, or for #12 the innermost
one around HGMMAs, a k loop: the prologue's and
epilogue's conversions, such as the output's packing to bf16, fall
outside it). The int8 expert kernels of csrc/moe_matmul.cu (#10's and
#11's, bf16 activations over int8 experts) count their weight bytes by
the instruction each weight passes through once: an FFMA in the gather
(one slot's row), an I2F or I2FP in the WMMA grouped kernel, two a bf16 pair in
the mma.sync grouped kernel (``s8x2_bf16x2``); their main loop is the
backward branch that holds the most of those. ``--tree DIR`` (the tool run by
its path) reads the library built from the checkout at DIR (a parent's,
unpacked from ``git archive``). Prints the card's name and power limit, then one JSON line per
instantiation.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

KERNELS = ("rk_int4_decode_kernel", "rk_int4_decode_mma_kernel",
           "rk_moe_gather_int4_decode_kernel", "rk_moe_gather_int4_mma_kernel",
           "rk_int4_a8_decode_kernel", "rk_moe_stack_wgmma_kernel",
           "rk_mlp4_gate_up_mma_kernel", "rk_mlp4_down_mma_kernel")
INTEGER_KERNELS = ("rk_int4_a8_decode_kernel",)   # packed bytes counted by IMMA
STACK_KERNELS = ("rk_moe_stack_wgmma_kernel",)    # int8 weights: 2 a bf16 pair
# int8 expert kernels (bf16 x, int8 w): the instruction each weight passes
# through once, and the weights it stands for ("HPAIR": a bf16 HADD2/HFMA2)
EXPERT_KERNELS = {"rk_moe_gather_partial_kernel": ("FFMA", 1),
                  "rk_moe_gather_stream_kernel": ("FFMA", 1),
                  "rk_moe_grouped_wmma_kernel": ("I2F|I2FP", 1),
                  "rk_moe_grouped_mma_kernel": ("HPAIR", 2)}
BYTES_PER_IMMA = 8
CONVERSIONS = ("I2F", "I2FP", "F2F", "F2FP", "F2I")
_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)")


def _tool(name: str) -> str:
    from ragmeup_tpu_torch import kernels
    for cand in (shutil.which(name),
                 os.path.join(os.path.dirname(kernels._nvcc()), name)):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(f"{name} not found beside nvcc")


def _demangle(names):
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names), text=True,
                             capture_output=True, check=True).stdout.splitlines()
        return out if len(out) == len(names) else list(names)
    except (RuntimeError, subprocess.CalledProcessError):
        return list(names)


def instructions(sass: str) -> dict:
    """{function name: [(address, opcode, operands)]} of every function in
    `sass`."""
    functions, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = functions.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        match = _INSTRUCTION.search(line) if current is not None else None
        if match:
            current.append((int(match.group(1), 16), match.group(2), match.group(3)))
    return functions


def _is_nibble_pair(op: str) -> bool:
    return op.split(".")[0] in ("HADD2", "HFMA2") and "BF16" in op


def _is_imma(op: str) -> bool:
    return op.startswith("IMMA")


def _is_hgmma(op: str) -> bool:
    return op.startswith("HGMMA")


def opcode_counts(code) -> dict:
    ops = {}
    for _, op, _ in code:
        ops[op] = ops.get(op, 0) + 1
    return ops


def main_loop(code, marker=_is_nibble_pair, innermost: bool = False) -> list:
    """The instructions between the target and the address of the backward
    branch whose range holds the most `marker` instructions (nibble pairs,
    or IMMAs); with `innermost`, the first range that holds any and no
    other such range (#12's k loops, one per wgmma N, sit inside its loop
    over (tile, strip) pairs)."""
    ranges = []
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            lo = int(target.group(1), 16)
            body = [ins for ins in code if lo <= ins[0] <= addr]
            marks = sum(marker(op) for _, op, _ in body)
            if marks:
                ranges.append((lo, addr, marks, body))
    if innermost:
        inner = [r for r in ranges if not any(o is not r and r[0] <= o[0] and o[1] <= r[1]
                                              for o in ranges)]
        return min(inner, key=lambda r: r[0])[3] if inner else []
    return max(ranges, key=lambda r: r[2])[3] if ranges else []


def _expert_marker(opcode: str):
    if opcode == "HPAIR":
        return _is_nibble_pair
    return lambda op: op.split(".")[0] in opcode.split("|")


def summarize(ops: dict, integer: bool = False, stack: bool = False,
              expert=None) -> dict:
    """Counts of one body of code; packed bytes from its bf16 nibble pairs
    or, for the W4A8 kernel (`integer`), from its IMMAs; for #12's stack
    kernel (`stack`) the int8 weights its bf16 pairs convert (two a pair)
    and its wgmmas (HGMMA); for an int8 expert kernel (`expert`, its
    EXPERT_KERNELS entry) the weights its marker instructions stand for."""
    pairs = sum(n for op, n in ops.items() if _is_nibble_pair(op))
    imma = sum(n for op, n in ops.items() if _is_imma(op))
    hgmma = sum(n for op, n in ops.items() if _is_hgmma(op))
    bytes_ = BYTES_PER_IMMA * imma if integer else 2 * pairs if stack else pairs
    if expert is not None:
        marker, per_mark = expert
        bytes_ = per_mark * sum(n for op, n in ops.items() if _expert_marker(marker)(op))
    conv = {op: n for op, n in ops.items() if op.split(".")[0] in CONVERSIONS}
    total = sum(ops.values())

    def per(count):
        return count / bytes_ if bytes_ else None
    return {"instructions": total, "bf16_nibble_pairs": pairs, "imma": imma, "hgmma": hgmma,
            "packed_bytes": bytes_,
            "prmt": sum(n for op, n in ops.items() if op.split(".")[0] == "PRMT"),
            "lop3": sum(n for op, n in ops.items() if op.split(".")[0] == "LOP3"),
            "ldg_128": sum(n for op, n in ops.items() if op.startswith("LDG") and "128" in op),
            "ldg": sum(n for op, n in ops.items() if op.startswith("LDG")),
            "hmma": sum(n for op, n in ops.items() if op.startswith("HMMA")),
            "conversions": conv,
            "conversions_per_packed_byte": per(sum(conv.values())),
            "instructions_per_packed_byte": per(total)}


def decode_kernel_counts(library: str) -> list:
    """[{kernel, counts...}] of the decode kernels in the library at `library`."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    names = KERNELS + tuple(EXPERT_KERNELS)
    functions = {name: code for name, code in instructions(sass).items()
                 if any(kernel in name for kernel in names)}
    if not functions:
        raise RuntimeError(f"no {' or '.join(names)} in the SASS of {library}")
    rows = []
    for name, pretty in zip(functions, _demangle(list(functions))):
        expert = next((v for kernel, v in EXPERT_KERNELS.items() if kernel in name), None)
        if expert is not None and ("signed char" not in pretty
                                   or ("gather" in name and "__nv_bfloat16" not in pretty)):
            continue    # the int8 expert kernels' bf16-x, int8-w instantiations only
        integer = any(kernel in name for kernel in INTEGER_KERNELS)
        stack = any(kernel in name for kernel in STACK_KERNELS)
        if stack and "signed char" not in pretty:
            continue    # #12's int8 instantiation only (bf16 and f32 weights convert no pair)
        marker = (_expert_marker(expert[0]) if expert else _is_imma if integer
                  else _is_hgmma if stack else _is_nibble_pair)
        loop = main_loop(functions[name], marker, innermost=stack)
        rows.append({"kernel": pretty,
                     **summarize(opcode_counts(functions[name]), integer, stack, expert),
                     "main_loop": summarize(opcode_counts(loop), integer, stack, expert)})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="checkout whose kernels to read (run "
                    "the tool by its path, python3 ragmeup_tpu_torch/tools/sass_count.py)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree or os.path.join(os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, tree)
    from ragmeup_tpu_torch import kernels
    if os.path.abspath(kernels.CSRC) != os.path.join(tree, "ragmeup_tpu_torch", "csrc"):
        raise SystemExit(f"sass_count: imported {kernels.__file__}, not {tree}'s")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or "no card", flush=True)
    for row in decode_kernel_counts(kernels.build()):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
