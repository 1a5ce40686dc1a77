"""Conversion instructions per packed byte in the int4 decode kernels' SASS.

    python3 -m ragmeup_tpu_torch.tools.sass_count

Builds the kernel library (``kernels.build()``), disassembles it with
``cuobjdump -sass`` and counts, for each instantiation of
``rk_int4_decode_kernel`` (csrc/quant_matmul_int4.cu: activation type,
rows M, batch, route) and of ``rk_int4_decode_mma_kernel`` (bf16, by
route), and of the expert gather's kernels on their bodies
(``rk_moe_gather_int4_decode_kernel``, ``rk_moe_gather_int4_mma_kernel``),
the instructions of its code by opcode. Every packed
byte the kernel consumes passes through exactly one bf16 HADD2/HFMA2
(``nibbles_bf16x2`` turns the two nibbles at one position of two packed
rows into bf16 integers: one per packed byte), so the conversions per
packed byte are the conversion instructions (I2F, I2FP, F2F, F2FP, F2I)
over that count. The counts are static (each instruction of the code once,
wherever a loop runs it), for the whole kernel and for its main loop (the
backward branch whose body holds the most of those HADD2/HFMA2s: the
prologue's and epilogue's conversions, such as the output's packing to
bf16, fall outside it). Prints the card's name and power limit, then one
JSON line per instantiation.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess

from ragmeup_tpu_torch import kernels

KERNELS = ("rk_int4_decode_kernel", "rk_int4_decode_mma_kernel",
           "rk_moe_gather_int4_decode_kernel", "rk_moe_gather_int4_mma_kernel")
CONVERSIONS = ("I2F", "I2FP", "F2F", "F2FP", "F2I")
_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*)")


def _tool(name: str) -> str:
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


def opcode_counts(code) -> dict:
    ops = {}
    for _, op, _ in code:
        ops[op] = ops.get(op, 0) + 1
    return ops


def main_loop(code) -> list:
    """The instructions between the target and the address of the backward
    branch whose range holds the most nibble-pair instructions."""
    best, best_pairs = [], 0
    for addr, op, rest in code:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < addr:
            body = [ins for ins in code if int(target.group(1), 16) <= ins[0] <= addr]
            pairs = sum(_is_nibble_pair(op) for _, op, _ in body)
            if pairs > best_pairs:
                best, best_pairs = body, pairs
    return best


def summarize(ops: dict) -> dict:
    bytes_ = sum(n for op, n in ops.items() if _is_nibble_pair(op))
    conv = {op: n for op, n in ops.items() if op.split(".")[0] in CONVERSIONS}
    return {"instructions": sum(ops.values()), "bf16_nibble_pairs": bytes_,
            "ldg_128": sum(n for op, n in ops.items() if op.startswith("LDG") and "128" in op),
            "conversions": conv,
            "conversions_per_packed_byte": sum(conv.values()) / bytes_ if bytes_ else None}


def decode_kernel_counts(library: str) -> list:
    """[{kernel, counts...}] of the decode kernels in the library at `library`."""
    sass = subprocess.run([_tool("cuobjdump"), "-sass", library],
                          capture_output=True, text=True, check=True).stdout
    functions = {name: code for name, code in instructions(sass).items()
                 if any(kernel in name for kernel in KERNELS)}
    if not functions:
        raise RuntimeError(f"no {' or '.join(KERNELS)} in the SASS of {library}")
    return [{"kernel": pretty, **summarize(opcode_counts(functions[name])),
             "main_loop": summarize(opcode_counts(main_loop(functions[name])))}
            for name, pretty in zip(functions, _demangle(list(functions)))]


def main() -> int:
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True)
    print(card.stdout.strip() or "no card", flush=True)
    for row in decode_kernel_counts(kernels.build()):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
