"""Instruction mix of the port's CUDA kernels, read from their SASS.

    python -m lidar_slam_arvc_tpu_torch.utils.sass

Builds the kernel library (``ops._cuda``), disassembles it with
``cuobjdump -sass`` and prints, per kernel, its instruction count, the
opcode histogram of its largest loop (the body between a backward branch
and its target), and its hot loop: the loop with the largest share of
FP32 arithmetic (FADD/FMUL/FFMA), the unrolled inner loop of a sweep.
There every scored pair updates its running best with one select (FSEL
after its compare), so the hot loop's instructions over its FSELs are the
issue slots a pair costs, what a kernel's issue-rate bound rests on (4
warp-instructions a cycle an SM).
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


def loops(func: dict) -> list[list[str]]:
    """The instructions of every backward-branch body."""
    out = []
    for addr, text in func["insns"]:
        m = _TARGET.search(text)
        if not m:
            continue
        tgt = func["labels"].get(m.group(1)) if m.group(1) else int(m.group(2), 16)
        if tgt is None or tgt >= addr:
            continue
        out.append([t for a, t in func["insns"] if tgt <= a <= addr])
    return out


def largest_loop(func: dict):
    """(instructions of the largest backward-branch body) or []."""
    return max(loops(func), key=len, default=[])


def _fp32_share(body: list[str]) -> float:
    return sum(_opcode(t).split(".")[0] in ("FADD", "FMUL", "FFMA")
               for t in body) / len(body)


def hot_loop(func: dict):
    """(instructions of the loop with the largest FP32-arithmetic share,
    the smallest on a tie) or []."""
    return max(loops(func), key=lambda b: (_fp32_share(b), -len(b)), default=[])


def main() -> int:
    so = _cuda._build()
    home = os.path.dirname(os.path.dirname(_cuda._nvcc()))
    tool = os.path.join(home, "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    for name, func in parse(out).items():
        loop = largest_loop(func)
        hist = collections.Counter(_opcode(t) for t in loop)
        hot = hot_loop(func)
        pairs = sum(_opcode(t) == "FSEL" for t in hot)
        hot_hist = collections.Counter(_opcode(t) for t in hot)
        per_pair = f"{len(hot) / pairs:.2f}" if pairs else "n/a"
        print(f"{name}: {len(func['insns'])} instructions; largest loop "
              f"{len(loop)}: " + ", ".join(f"{k} {v}" for k, v in hist.most_common())
              + f"; hot loop {len(hot)} instructions, {pairs} FSEL, "
              f"{per_pair} issue slots per pair: "
              + ", ".join(f"{k} {v}" for k, v in hot_hist.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
