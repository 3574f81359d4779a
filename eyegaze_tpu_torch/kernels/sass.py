"""Static instruction counts from the SASS of a built kernel library.

``cuobjdump --dump-sass`` lists each kernel's instructions with their
addresses.  A kernel's main loop is the backward branch whose range holds
the most tensor-core instructions; its instructions, sorted into classes,
are counted once each (static counts: an inner loop counts once, whatever
its trip count).
"""

from __future__ import annotations

import re
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

# Opcode classes of the counts; anything else (integer and address
# arithmetic, moves, branches, predicates) is "other".
CLASSES = {
    "tensor": {"HMMA", "HGMMA"},
    "sfu": {"MUFU"},
    "fp32": {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FSET"},
    "convert": {"F2FP", "F2F", "I2F", "F2I"},
    "shared": {"LDS", "LDSM", "STS", "STSM"},
    "memory": {"LDG", "STG", "LD", "ST", "LDGSTS", "ATOM", "ATOMS", "RED"},
    "sync": {"BAR", "SYNCS", "WARPSYNC", "DEPBAR", "LDGDEPBAR", "MEMBAR", "UCGABAR_ARV",
             "UCGABAR_WAIT", "WARPGROUP", "WARPGROUPSET"},
}

Instruction = Tuple[int, str, str]  # (address, opcode without modifiers, operands)


def dump(lib: Path) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cuobjdump = Path(CUDA_HOME) / "bin" / "cuobjdump"
    return subprocess.run([str(cuobjdump), "--dump-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout


def functions(sass: str, pattern: str) -> Dict[str, List[Instruction]]:
    """The instructions of each function whose mangled name matches
    ``pattern`` (a regex searched in the ``Function :`` line), by the
    pattern's match."""
    code: Dict[str, List[Instruction]] = {}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            head = re.search(pattern, line)
            name = head.group(0) if head else None
            if name:
                code[name] = []
        elif name:
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*?);",
                           line)
            if ins:
                code[name].append((int(ins.group(1), 16), ins.group(2).split(".")[0],
                                   ins.group(3)))
    return code


def main_loop(ins: List[Instruction]) -> List[str]:
    """The opcodes of the backward branch's range holding the most
    tensor-core instructions (empty if no loop holds any)."""
    best: List[str] = []
    best_tc = 0
    for addr, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            body = [o for a, o, _ in ins if int(target.group(1), 16) <= a <= addr]
            tc = sum(o in CLASSES["tensor"] for o in body)
            if tc > best_tc:
                best, best_tc = body, tc
    return best


def mix(body: List[str], per: float) -> Dict[str, float]:
    """The opcode classes of a loop body (and its total) over ``per``."""
    out = {cls: sum(o in ops for o in body) / per for cls, ops in CLASSES.items()}
    out["other"] = (len(body) - sum(sum(o in ops for o in body) for ops in CLASSES.values())) / per
    out["total"] = len(body) / per
    return out
