"""Instruction mix of the port's CUDA kernels, read from their SASS.

    python -m lidar_slam_arvc_tpu_torch.utils.sass

Builds the kernel library (``ops._cuda``), disassembles it with
``cuobjdump -sass`` and prints, per kernel, its instruction count and the
opcode histogram of its largest loop (the body between a backward branch
and its target).  That loop is the sweep's unrolled inner loop, so its FP32
instructions per scored pair are what a kernel's operation bound rests on.
Needs the CUDA toolkit (``cuobjdump`` beside ``nvcc``); no card.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

from lidar_slam_arvc_tpu_torch.ops import _cuda

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"BRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))")


def _opcode(text: str) -> str:
    tok = text.split()
    if tok and tok[0].startswith("@"):
        tok = tok[1:]
    return tok[0] if tok else ""


def parse(sass: str) -> dict:
    """{kernel name: [(address, instruction text), ...]} and its labels."""
    funcs, cur, pending = {}, None, []
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), {"insns": [], "labels": {}})
            continue
        if cur is None:
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m:
            addr = int(m.group(1), 16)
            for lab in pending:
                cur["labels"][lab] = addr
            pending = []
            cur["insns"].append((addr, m.group(2)))
    return funcs


def largest_loop(func: dict):
    """(instructions of the largest backward-branch body) or []."""
    best = []
    for addr, text in func["insns"]:
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = func["labels"].get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is None or tgt >= addr:
            continue
        body = [t for a, t in func["insns"] if tgt <= a <= addr]
        if len(body) > len(best):
            best = body
    return best


def main() -> int:
    so = _cuda._build()
    home = os.path.dirname(os.path.dirname(_cuda._nvcc()))
    tool = os.path.join(home, "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    for name, func in parse(out).items():
        loop = largest_loop(func)
        hist = collections.Counter(_opcode(t) for t in loop)
        print(f"{name}: {len(func['insns'])} instructions; largest loop "
              f"{len(loop)}: " + ", ".join(f"{k} {v}" for k, v in hist.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
