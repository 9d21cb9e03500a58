"""Instruction mix of the port's CUDA kernels, read from their SASS.

    python -m lidar_slam_arvc_tpu_torch.utils.sass

Builds the kernel library (``ops._cuda``), disassembles it with
``cuobjdump -sass`` and prints, per kernel, its instruction count, the
opcode histogram of its largest loop (the body between a backward branch
and its target), and its hot loop: the loop with the largest share of
FP32 arithmetic (FADD/FMUL/FFMA), the unrolled inner loop of a sweep.
In the exhaustive sweeps (K1, K3, K4) every scored pair updates its
running minimum with one FMNMX; in K5 every scored pair updates its
running best with one select (FSEL after its compare); K2 (ball moments)
has neither, and every scored pair there makes one ball compare (FSETP
against r^2).  So the hot loop's instructions over its FMNMXs, or over
its FSELs where it has none, or over its FSETPs where it has neither, are
the issue slots a pair costs, what a kernel's issue-rate bound rests on
(4 warp-instructions a cycle an SM).  Instructions that a
predicated forward branch inside the loop jumps over (K2's ten
accumulations, run only for a pair inside the ball) are counted apart:
they cost their slots only for the pairs that take the branch.  Each kernel's line
also gives its registers, shared memory and spills from ``ptxas -v`` (the
build log).
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


def _target(func: dict, text: str) -> int | None:
    """The address a branch instruction jumps to, or None."""
    m = _TARGET.search(text)
    if not m:
        return None
    return func["labels"].get(m.group(1)) if m.group(1) else int(m.group(2), 16)


def _spans(func: dict) -> list[tuple[int, int]]:
    """(first, last) address of every backward-branch body."""
    out = []
    for addr, text in func["insns"]:
        tgt = _target(func, text)
        if tgt is not None and tgt < addr:
            out.append((tgt, addr))
    return out


def _body(func: dict, span: tuple[int, int]) -> list[str]:
    return [t for a, t in func["insns"] if span[0] <= a <= span[1]]


def loops(func: dict) -> list[list[str]]:
    """The instructions of every backward-branch body."""
    return [_body(func, s) for s in _spans(func)]


def largest_loop(func: dict):
    """(instructions of the largest backward-branch body) or []."""
    return max(loops(func), key=len, default=[])


def _fp32_share(body: list[str]) -> float:
    return sum(_opcode(t).split(".")[0] in ("FADD", "FMUL", "FFMA")
               for t in body) / len(body)


def _hot_span(func: dict) -> tuple[int, int] | None:
    def key(span):
        body = _body(func, span)
        return _fp32_share(body), -len(body)
    return max(_spans(func), key=key, default=None)


def hot_loop(func: dict):
    """(instructions of the loop with the largest FP32-arithmetic share,
    the smallest on a tie) or []."""
    span = _hot_span(func)
    return _body(func, span) if span else []


def branch_bodies(func: dict) -> list[str]:
    """The hot loop's instructions that a predicated forward branch inside
    it jumps over: in K2, the accumulations that only a neighbour (a pair
    inside the ball) runs.  [] where the loop has no such branch."""
    span = _hot_span(func)
    if span is None:
        return []
    skipped = set()
    for addr, text in func["insns"]:
        if span[0] <= addr <= span[1] and text.startswith("@"):
            tgt = _target(func, text)
            if tgt is not None and addr < tgt <= span[1]:
                skipped.update(a for a, _ in func["insns"] if addr < a < tgt)
    return [t for a, t in func["insns"] if a in skipped]


def pairs_in(hot: list[str]) -> tuple[int, str]:
    """(scored pairs one pass of the hot loop covers, the opcode counted):
    its FMNMXs (running minima), or its FSELs (running bests) where it has
    none, or its FSETPs (ball compares) where it has neither."""
    for op in ("FMNMX", "FSEL", "FSETP"):
        n = sum(_opcode(t).split(".")[0] == op for t in hot)
        if n:
            return n, op
    return 0, "FSEL"


_ENTRY = re.compile(r"(?:Compiling entry function|Function properties for) '?([^'\s]+)'?")


def ptxas_usage(log: str) -> dict:
    """{kernel: "N registers, M bytes smem, S bytes stack, spills ..."} from
    ``ptxas -v`` output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out.setdefault(cur, {}).update(stack=int(m.group(1)),
                                           spills=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.setdefault(cur, {}).update(registers=int(m.group(1)),
                                           smem=int(smem.group(1)) if smem else 0)
    return {k: (f"{v.get('registers', '?')} registers, {v.get('smem', 0)} bytes "
                f"static smem, {v.get('stack', 0)} bytes stack, "
                f"{v.get('spills', 0)} bytes spilled") for k, v in out.items()}


def disassemble() -> tuple[dict, dict]:
    """(the kernel library's SASS as ``parse`` gives it, ``ptxas_usage`` of
    its build log); builds the library first."""
    so = _cuda._build()
    home = os.path.dirname(os.path.dirname(_cuda._nvcc()))
    tool = os.path.join(home, "bin", "cuobjdump")
    out = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                         check=True).stdout
    log_path = so + ".log"
    usage = ptxas_usage(open(log_path).read()) if os.path.exists(log_path) else {}
    return parse(out), usage


def issue_slots_per_pair(func: dict) -> tuple[float | None, float, int, int, str]:
    """(issue slots every scored pair costs or None, issue slots more for a
    pair that takes the loop's branches (``branch_bodies``; a K2
    neighbour), hot loop instructions, pairs it covers, the opcode counted
    as one pair) of one kernel.  A run's issue slots are pairs x the first
    plus pairs taking the branch x the second."""
    hot = hot_loop(func)
    pairs, op = pairs_in(hot)
    if not pairs:
        return None, 0.0, len(hot), pairs, op
    body = len(branch_bodies(func))
    return (len(hot) - body) / pairs, body / pairs, len(hot), pairs, op


def main() -> int:
    funcs, usage = disassemble()
    for name, func in funcs.items():
        loop = largest_loop(func)
        hist = collections.Counter(_opcode(t) for t in loop)
        hot = hot_loop(func)
        per_pair, branch, _, pairs, op = issue_slots_per_pair(func)
        hot_hist = collections.Counter(_opcode(t) for t in hot)
        print(f"{name}: {usage.get(name, 'ptxas usage not in the build log')}; "
              f"{len(func['insns'])} instructions; largest loop "
              f"{len(loop)}: " + ", ".join(f"{k} {v}" for k, v in hist.most_common())
              + f"; hot loop {len(hot)} instructions, {pairs} {op}, "
              + (f"{per_pair:.2f}" if per_pair else "n/a")
              + " issue slots per pair"
              + (f" and {branch:.2f} more per pair taking its branch" if branch else "")
              + ": "
              + ", ".join(f"{k} {v}" for k, v in hot_hist.most_common()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
