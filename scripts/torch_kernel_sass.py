#!/usr/bin/env python3
"""What the card runs for each of lvt_tpu_torch's kernels: SASS opcodes.

    python3 scripts/torch_kernel_sass.py [--out build/sass]

Builds the kernels (``lvt_tpu_torch.kernels.build``), disassembles the
library with ``cuobjdump -sass`` and prints, for each kernel, its number
of instructions and its opcodes (with modifiers, e.g. ``VIMNMX3.U16x2``)
by count; the full listing of each kernel goes to ``--out``. It shows
whether an intrinsic is one instruction or an emulated sequence, and how
many instructions a comparison costs. Needs the CUDA toolkit (nvcc,
cuobjdump); it runs on the GPU machine.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.x]*)")


def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                        "cuobjdump")


def kernels_sass(lib_path: str) -> dict[str, list[str]]:
    """{kernel function name: its SASS lines} of one shared library."""
    text = subprocess.run([_cuobjdump(), "-sass", lib_path], check=True,
                          capture_output=True, text=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name is not None:
            out[name].append(line)
    return out


def opcodes(lines: list[str]) -> collections.Counter:
    return collections.Counter(m.group(1) for line in lines
                               if (m := _INSN.search(line)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(ROOT, "build", "sass"))
    args = p.parse_args(argv)
    from lvt_tpu_torch import kernels

    lib = kernels.build(verbose=True)   # prints ptxas registers and spills
    os.makedirs(args.out, exist_ok=True)
    report = {}
    for name, lines in sorted(kernels_sass(str(lib)).items()):
        ops = opcodes(lines)
        short = re.sub(r"^_ZN12_GLOBAL__N_1\d+", "", name)
        with open(os.path.join(args.out, f"{short[:60]}.sass"), "w") as f:
            f.write("\n".join(lines) + "\n")
        report[short] = dict(total=sum(ops.values()), opcodes=dict(
            ops.most_common()))
        print(f"{short}: {sum(ops.values())} instructions", flush=True)
        print("  " + ", ".join(f"{k} {v}" for k, v in ops.most_common()),
              flush=True)
    with open(os.path.join(args.out, "opcodes.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"listings and opcodes.json written to {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
