"""Count the instructions a window pair of the packed kernels' inner loop.

Builds the kernel library (``_build.kernels()``), disassembles it with
``cuobjdump -sass`` and, for the kernel whose mangled name contains
``--kernel`` (by default ``packed_bytes_kernelILi5ELi0E``: kernels D to G
at five code planes, an alphabet of 17 to 32 letters, landing in the
matrix), takes its innermost loop closed by a backward branch that holds
a ``POPC``, and in it the common path: from the loop's first instruction
to its closing branch, through every ``POPC`` of the loop, with the
fewest instructions besides (the step in which no sequence changes and
the warp's vote is false, so no weight is looked up). One ``POPC`` is one
window pair, so the path's instructions over its ``POPC`` are the
instructions a window pair. Prints one JSON line, and with ``--listing``
the loop's instructions, those on the path marked ``*``::

    python -m fastsk_tpu_torch.experiments.sass_loop [--kernel NAME] [--listing FILE]

``chip_smoke.py`` calls ``loop_stats`` on the library it builds. Needs the
CUDA toolkit (``nvcc``, ``cuobjdump``), so the card's machine.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

from .. import _build

DEFAULT_KERNEL = "packed_bytes_kernelILi5ELi0E"
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_TARGET = re.compile(r"\bBRA\b.*?0x([0-9a-f]+)")


def functions(sass: str):
    """{mangled name: [(address, instruction text)]} of a cuobjdump listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2)))
    return out


def popc_loops(insns):
    """Loops [target, branch] closed by a backward branch that hold a POPC,
    innermost (shortest) first."""
    loops = []
    for addr, text in insns:
        m = _TARGET.search(text)
        if m:
            target = int(m.group(1), 16)
            body = [(a, t) for a, t in insns if target <= a <= addr]
            if target < addr and any("POPC" in t for _, t in body):
                loops.append(body)
    return sorted(loops, key=len)


def _successors(loop, i):
    """Indices after instruction i of ``loop`` (len(loop): the end of the
    step, reached by the closing branch or a branch back to the head)."""
    addr, text = loop[i]
    end = len(loop)
    if i == end - 1:
        return [end]
    if text.startswith(("EXIT", "RET")):
        return []
    m = _TARGET.search(text)
    if not m:
        return [i + 1]
    target = int(m.group(1), 16)
    at = {a: j for j, (a, _) in enumerate(loop)}
    out = []
    if target == loop[0][0]:
        out.append(end)
    elif target > addr and target in at:
        out.append(at[target])
    conditional = text.startswith("@") or ".DIV" in text or re.search(r"BRA\S*\s+!?U?P\d", text)
    if conditional:
        out.append(i + 1)
    return out


def common_path(loop):
    """The instructions of ``loop`` on its path from its first instruction
    to its closing branch that passes the most POPC and, among those, the
    fewest instructions (branches inside the step go forward only)."""
    n = len(loop)
    best = [None] * (n + 1)  # (-popc, instructions, previous index)
    best[0] = (-int("POPC" in loop[0][1]), 1, None)
    for i in range(n):
        if best[i] is None:
            continue
        for j in _successors(loop, i):
            if j <= i:
                continue
            cand = (best[i][0] - (j < n and "POPC" in loop[j][1]), best[i][1] + (j < n), i)
            if best[j] is None or cand[:2] < best[j][:2]:
                best[j] = cand
    if best[n] is None:
        raise ValueError("no path through the loop reaches its closing branch")
    path, i = [], best[n][2]
    while i is not None:
        path.append(i)
        i = best[i][2]
    return [loop[i] for i in reversed(path)]


def _count(insns, op: str) -> int:
    return sum(1 for _, t in insns if re.search(rf"(^|\s){op}\b", t))


def loop_stats(kernel: str = DEFAULT_KERNEL, listing: str | None = None) -> dict:
    """The inner loop of ``kernel`` in the built library: its instructions,
    the common path's instructions, POPC, LOP3 and shared loads, and the
    instructions a window pair (path / POPC on it); the loop written to
    ``listing`` when given."""
    path = _build.kernels()._name
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    names = [name for name in functions(sass) if kernel in name]
    if len(names) != 1:
        raise ValueError(f"{len(names)} kernels match {kernel!r} in {path}")
    loops = popc_loops(functions(sass)[names[0]])
    if not loops:
        raise ValueError(f"no loop with a POPC in {names[0]}")
    loop = loops[0]
    on = common_path(loop)
    popc = _count(on, "POPC")
    if listing:
        marked = {a for a, _ in on}
        with open(listing, "w") as f:
            f.write(f"== {names[0]}\n")
            f.writelines(f"{'*' if a in marked else ' '} {a:#06x}  {t}\n" for a, t in loop)
    return {
        "kernel": names[0], "loop_instructions": len(loop), "path_instructions": len(on),
        "popc": popc, "lop3": _count(on, "LOP3.LUT"), "lds": _count(on, r"LDS(\.[A-Z0-9.]+)?"),
        "per_pair": len(on) / popc,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", default=DEFAULT_KERNEL)
    ap.add_argument("--listing", default=None, help="write the loop here, the path marked")
    args = ap.parse_args(argv)
    print(json.dumps(loop_stats(args.kernel, args.listing)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
