"""Instruction counts of the built kernels' SASS, for their operation bound.

    python -m ctgan_tpu_torch.kernels.sass [path/to/lib.so]

``cuobjdump -sass`` disassembles a library (by default the built
``libdropout_mask.so``).  :func:`kernel_counts` finds each kernel's main
loop, the longest loop that holds the function's widest store, and walks
the shortest path through it that passes that store: the path of a full
chunk of elements (a ragged tail's code, where a design keeps it in the
loop, is longer).  Along that path it counts instructions by kind and the
bytes stored, which give the elements per loop step.  :func:`op_bound_ms` turns
the counts into the least time the card could take for ``n`` elements:
each kind of instruction at its peak rate per SM and clock, the CUDA C++
Programming Guide's arithmetic-instruction throughput for compute
capability 9.0, which the H100 SXM (NVIDIA H100 80GB HBM3, 700 W limit)
is (32-bit integer add, multiply-add, shift, compare and
bitwise operations 64; fp32 add and multiply 128; other type conversions
16), and no SM issuing more than 128 per clock (four schedulers, one warp
instruction each); the slowest of these is the bound.  Memory, control and
uniform-datapath instructions (``U*``, once per warp) are counted and not
timed: the byte bound covers the stores.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

from .build import build_libraries, library_path, nvcc_path

__all__ = ["PER_CLK_PER_SM", "classify", "disassemble", "kernel_counts", "op_bound_ms", "parse"]

# peak thread-instructions per clock per SM of each timed kind (compute capability 9.0)
PER_CLK_PER_SM = {"int": 64, "fp32": 128, "cvt": 16}
DISPATCH_PER_CLK_PER_SM = 128
_FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FADD32I", "FMUL32I", "FFMA32I", "FCHK"}
_CVT = {"I2F", "F2I", "F2F", "I2I", "I2FP", "F2FP", "F2IP"}
_CTRL = {"BRA", "EXIT", "BSSY", "BSYNC", "BPT", "CALL", "RET", "JMP", "JMX", "BRX", "WARPSYNC", "BAR", "NOP",
         "YIELD", "BMOV", "S2R", "CS2R", "DEPBAR", "ELECT", "ACQBULK", "KILL", "NANOSLEEP", "BREAK"}
_MEM_PREFIXES = ("LD", "ST", "ATOM", "RED", "CCTL", "MEMBAR", "FENCE", "ERRBAR")

_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTRUCTION = re.compile(r"^\s*/\*([0-9a-fA-F]+)\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b(0x[0-9a-fA-F]+)\b")


@dataclasses.dataclass
class Instruction:
    addr: int
    pred: str  # "" or the guard, e.g. "@!P0"
    op: str  # the full opcode, e.g. "IMAD.WIDE.U32"
    args: str
    target: int | None = None  # a branch's target address

    @property
    def base(self) -> str:
        return self.op.split(".")[0]

    @property
    def is_branch(self) -> bool:
        return self.base in ("BRA", "BRX", "JMP", "JMX")

    @property
    def is_conditional(self) -> bool:
        """A branch that may fall through: guarded by a predicate other
        than PT, or taking a condition operand (``BRA.U !UP0, ...``)."""
        return (bool(self.pred) and self.pred not in ("@PT",)) or "," in self.args

    @property
    def store_bytes(self) -> int:
        if not self.base.startswith("ST"):
            return 0
        for suffix, width in ((".128", 16), (".64", 8), (".U16", 2), (".S16", 2), (".U8", 1), (".S8", 1)):
            if suffix in self.op:
                return width
        return 4


def classify(op: str) -> str:
    """The kind of an opcode: int, fp32, cvt, mem, ctrl or uniform."""
    base = op.split(".")[0]
    if base in _FP32:
        return "fp32"
    if base in _CVT:
        return "cvt"
    if base in _CTRL:
        return "ctrl"
    if base.startswith(_MEM_PREFIXES):
        return "mem"
    if base.startswith("U") or base in ("S2UR", "R2UR"):
        return "uniform"
    return "int"


def disassemble(lib: Path) -> str:
    cuobjdump = Path(nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, timeout=120,
                          check=True).stdout


def parse(sass: str) -> dict[str, list[Instruction]]:
    """Each function's instructions in address order, branch targets
    resolved (hexadecimal addresses, or ``.L_x_N`` labels)."""
    functions: dict[str, list[Instruction]] = {}
    labels: dict[str, int] = {}
    pending: list[str] = []
    raw_targets: list[tuple[Instruction, str]] = []
    current = None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            current = functions.setdefault(m.group(1), [])
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSTRUCTION.match(line)
        if m is None or current is None:
            continue
        text = m.group(2).strip()
        pred = ""
        if text.startswith("@"):
            pred, text = text.split(None, 1)
        op, _, args = text.partition(" ")
        ins = Instruction(int(m.group(1), 16), pred, op, args.strip())
        for label in pending:
            labels[label] = ins.addr
        pending = []
        if ins.is_branch:
            found = _TARGET.findall(ins.args)
            if found:
                label, hexaddr = found[-1]
                raw_targets.append((ins, label or hexaddr))
        current.append(ins)
    for ins, target in raw_targets:
        ins.target = int(target, 16) if target.startswith("0x") else labels.get(target)
    return functions


def _shortest_path(body: list[Instruction], start: int, end: int) -> list[int]:
    """Indices of the shortest path from ``body[start]`` to ``body[end]``
    along fall-through and forward branches (inner loops taken zero times)."""
    index = {ins.addr: i for i, ins in enumerate(body)}
    dist, prev = {start: 0}, {}
    for i in range(start, end):
        if i not in dist:
            continue
        ins = body[i]
        nexts = []
        if not ((ins.is_branch and not ins.is_conditional) or ins.base == "EXIT"):
            nexts.append(i + 1)
        if ins.is_branch and ins.target in index and i < index[ins.target] <= end:
            nexts.append(index[ins.target])
        for j in nexts:
            if dist[i] + 1 < dist.get(j, 1 << 30):
                dist[j], prev[j] = dist[i] + 1, i
    if end not in dist:
        raise ValueError(f"no path from {body[start].addr:#x} to {body[end].addr:#x}")
    path = [end]
    while path[-1] != start:
        path.append(prev[path[-1]])
    return path[::-1]


def loop_path(instructions: list[Instruction]) -> list[Instruction]:
    """The instructions one full step of the main loop executes: the
    longest loop among those holding the function's widest store."""
    index = {ins.addr: i for i, ins in enumerate(instructions)}
    widest = max(ins.store_bytes for ins in instructions)
    loops = [(index[ins.target], i) for i, ins in enumerate(instructions)
             if ins.is_branch and ins.target in index and index[ins.target] < i
             and any(x.store_bytes == widest for x in instructions[index[ins.target]:i])]
    if not widest or not loops:
        raise ValueError("no loop holding a store")
    head, back = max(loops, key=lambda loop: loop[1] - loop[0])
    body = instructions[head:back + 1]
    widest = max(range(len(body)), key=lambda i: (body[i].store_bytes, -i))
    path = _shortest_path(body, 0, widest) + _shortest_path(body, widest, len(body) - 1)[1:]
    return [body[i] for i in path]


# the kernels of csrc/dropout_mask.cu, by a part of their mangled names, with
# the bytes of one element (the first design's template named the element
# size, the present one names the element type)
KERNELS = {
    "dropout_mask float32": (("dropout_mask_kernel", ("IjE", "ILi4E")), 4),
    "dropout_mask bfloat16": (("dropout_mask_kernel", ("ItE", "ILi2E")), 2),
    "philox_uniform": (("philox_uniform_kernel", ("",)), 4),
}


def kernel_counts(sass: str) -> dict[str, dict]:
    """Per kernel: the loop step's elements and Philox blocks, and its
    instructions by kind and by opcode."""
    functions = parse(sass)
    out = {}
    for key, ((stem, tags), itemsize) in KERNELS.items():
        names = [n for n in functions if stem in n and any(tag in n for tag in tags)]
        if len(names) != 1:
            raise ValueError(f"{key}: found {names} in the SASS")
        path = loop_path(functions[names[0]])
        elements = sum(ins.store_bytes for ins in path) // itemsize
        kinds, opcodes = {}, {}
        for ins in path:
            kinds[classify(ins.op)] = kinds.get(classify(ins.op), 0) + 1
            opcodes[ins.op] = opcodes.get(ins.op, 0) + 1
        out[key] = dict(function=names[0], elements=elements, philox_blocks=elements / 4,
                        instructions=len(path), kinds=kinds,
                        opcodes=dict(sorted(opcodes.items(), key=lambda kv: -kv[1])))
    return out


def op_bound_ms(counts: dict, n: int, sms: int, clock_hz: float) -> tuple[float, str]:
    """The least time for ``n`` elements of a kernel with ``counts`` (one
    entry of :func:`kernel_counts`), and the kind that sets it."""
    steps = n / counts["elements"]
    kinds = counts["kinds"]
    times = {kind: kinds.get(kind, 0) / rate for kind, rate in PER_CLK_PER_SM.items()}
    times["dispatch"] = sum(kinds.get(k, 0) for k in (*PER_CLK_PER_SM, "mem", "ctrl")) / DISPATCH_PER_CLK_PER_SM
    kind = max(times, key=times.get)
    return steps * times[kind] / (sms * clock_hz) * 1e3, kind


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        lib = Path(argv[0])
    else:
        build_libraries(["dropout_mask"])
        lib = library_path("dropout_mask")
    print(json.dumps(kernel_counts(disassemble(lib)), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
