"""What the compiler made of each card kernel: ptxas's resource report and a
hash of the SASS, one line per kernel, for comparing two builds.

Builds the port's library (with any extra measurement flags) and prints,
per kernel entry (mangled name): registers, stack frame, spill stores and
loads (``nvcc -Xptxas -v``, the log beside the library), the number of
SASS instructions and a hash of their text (``cuobjdump -sass``). Two
checkouts give the same line for a kernel whose compiled code did not
change. ``--ops PATTERN`` adds, for the kernels whose name matches, a
count of each SASS opcode (what a fold loop compiled to).

    python -m openintel_tpu_torch.tools.ptxas_report [--flags=-DOI_C_FOLD=2]
        [--ops turbo_i8_tma]

Needs nvcc and cuobjdump (the CUDA toolkit); no card.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from openintel_tpu_torch.ops import _kernels

_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
# an anonymous namespace's mangled name carries a hash of the source's path
_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]{8}")


def kernel_name(mangled: str) -> str:
    """The mangled name with its anonymous namespace's path hash taken out,
    so that two checkouts name a kernel alike."""
    return _ANON.sub(r"_ANON_\1", mangled)


def ptxas_entries(log: str) -> dict[str, dict]:
    """Per entry function of an ``-Xptxas -v`` log: regs, stack, spills."""
    out, name = {}, None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            name = kernel_name(m.group(1))
            out[name] = {}
            continue
        if name is None:
            continue
        m = _FRAME.search(line)
        if m:
            out[name].update(stack=int(m[1]), spill_st=int(m[2]), spill_ld=int(m[3]))
        m = _REGS.search(line)
        if m:
            out[name]["regs"] = int(m[1])
    return out


def sass_functions(so: Path, cuobjdump: str) -> dict[str, list[str]]:
    """The SASS instructions of each kernel in the library."""
    text = subprocess.run(
        [cuobjdump, "-sass", str(so)], capture_output=True, text=True, check=True
    ).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            name = kernel_name(line.split("Function : ", 1)[1].strip())
            out[name] = []
        elif name is not None:
            m = _INSTR.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def opcode(instr: str) -> str:
    """The opcode of a SASS instruction, past its predicate (``@!P0``)."""
    tokens = instr.split()
    return tokens[1] if tokens[0].startswith("@") and len(tokens) > 1 else tokens[0]


def find_cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    path = Path(_kernels.find_nvcc()).with_name("cuobjdump")
    if not path.is_file():
        raise FileNotFoundError("cuobjdump not found beside nvcc")
    return str(path)


def report(flags: tuple[str, ...], ops: str | None) -> list[str]:
    so, _ = _kernels.build(flags)
    entries = ptxas_entries(so.with_suffix(".log").read_text())
    sass = sass_functions(so, find_cuobjdump())
    lines = []
    for name in sorted(set(entries) | set(sass)):
        e, code = entries.get(name, {}), sass.get(name, [])
        digest = hashlib.sha256("\n".join(code).encode()).hexdigest()[:16]
        lines.append(
            f"{name} regs {e.get('regs')} stack {e.get('stack')} spill {e.get('spill_st')}/"
            f"{e.get('spill_ld')} sass {len(code)} {digest}"
        )
        if ops and ops in name:
            hist = collections.Counter(opcode(i) for i in code)
            top = ", ".join(f"{op} {n}" for op, n in hist.most_common())
            lines.append(f"  ops: {top}")
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--flags", default="", help="space-separated extra nvcc flags (--flags=-DX=1)"
    )
    parser.add_argument("--ops", default=None, help="kernels whose opcodes to count")
    args = parser.parse_args(argv)
    for line in report(tuple(args.flags.split()), args.ops):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
