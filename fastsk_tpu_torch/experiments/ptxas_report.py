"""What ptxas makes of kernel A's and H's source (``csrc/pairs.cu``): each
kernel's registers, spills and static shared memory (``nvcc -Xptxas -v``
with the library's flags), its SASS instruction count and a digest of its
SASS (``cuobjdump``, labels renumbered within the kernel), the compile's
seconds and the kernels whose wgmma ptxas serializes.

    python -m fastsk_tpu_torch.experiments.ptxas_report [--other DIR]

``--other DIR`` compiles the same source from another checkout's
``fastsk_tpu_torch/csrc`` too (for instance an older commit unpacked with
``git archive`` into a git-ignored directory) and lists, for each of its
kernels, the kernels of this tree with the same SASS digest, so that a
kernel can be shown unchanged. Needs the CUDA toolkit; the last line of
stdout is one JSON object.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

from .. import _build

_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_SERIAL = re.compile(r"wgmma.mma_async instructions are serialized.*function '([^']+)'")
_LABEL = re.compile(r"\.L_x_\d+")


def demangle(names):
    """Demangled names (cu++filt from the toolkit), or the names as given."""
    tool = shutil.which("cu++filt") or os.path.join(
        os.path.dirname(_build.nvcc_path()), "cu++filt"
    )
    if not os.path.exists(tool) or not names:
        return {n: n for n in names}
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True).stdout
    return dict(zip(names, out.splitlines()))


def sass_of(obj: str) -> dict:
    """{mangled kernel: (instructions, digest)} of an object's SASS."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", obj], capture_output=True, text=True, check=True).stdout
    kernels, name, lines = {}, None, []

    def close():
        if name is not None:
            labels = {}
            body = "\n".join(
                _LABEL.sub(lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"), ln)
                for ln in lines
            )
            kernels[name] = (len(lines), hashlib.sha256(body.encode()).hexdigest()[:16])

    for raw in text.splitlines():
        if "Function : " in raw:
            close()
            name, lines = raw.split("Function : ", 1)[1].strip(), []
        elif name is not None and raw.strip().startswith("/*") and ";" in raw:
            lines.append(raw.split("/*", 2)[1].split("*/", 1)[1].split(";")[0].strip())
    close()
    return kernels


SOURCE = "pairs.cu"


def report(csrc: str) -> dict:
    """Compile ``csrc/pairs.cu`` to an object; its kernels' facts."""
    with tempfile.TemporaryDirectory(prefix="ptxas_report_") as tmp:
        obj = os.path.join(tmp, "k.o")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-c", os.path.join(csrc, SOURCE), "-o", obj],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}/{SOURCE}:\n{proc.stderr}")
        facts, name = {}, None
        for line in proc.stderr.splitlines():
            if m := _ENTRY.search(line):
                name = m.group(1)
                facts[name] = {}
            elif name and (m := _SPILL.search(line)):
                facts[name]["spill_stores"], facts[name]["spill_loads"] = map(int, m.groups())
            elif name and (m := _USED.search(line)):
                facts[name]["registers"] = int(m.group(1))
                s = _SMEM.search(line)
                facts[name]["smem"] = int(s.group(1)) if s else 0
        serialized = sorted(set(_SERIAL.findall(proc.stderr)))
        for mangled, (n, digest) in sass_of(obj).items():
            if mangled in facts:
                facts[mangled].update(sass_instructions=n, sass_digest=digest)
    names = demangle(list(facts))
    return {
        "seconds": seconds,
        "kernels": {names[k]: v for k, v in facts.items()},
        "wgmma_serialized": [names.get(k, k) for k in serialized],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", default="", help="another checkout's root, to compare")
    args = ap.parse_args(argv)
    out = {"source": SOURCE, "this": report(_build.CSRC)}
    if args.other:
        other = report(os.path.join(args.other, "fastsk_tpu_torch", "csrc"))
        by_digest = {}
        for name, f in out["this"]["kernels"].items():
            by_digest.setdefault(f.get("sass_digest"), []).append(name)
        out["other"] = other
        out["same_sass"] = {
            name: by_digest.get(f.get("sass_digest"), []) for name, f in other["kernels"].items()
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
