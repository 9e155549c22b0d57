#!/usr/bin/env python3
"""walk_c_kernel's two starts side by side in the card's machine code:
csrc/walk.cu built for sm_90a as a cubin (nvcc -cubin, the flags of
native_build), its SASS read with cuobjdump, and for each entry type
(int16, int32) the kernel that takes each lane's walk length from the
lanes' inputs (kLanes, csrc/lanes.cuh::lane_out) against the one that
reads it as given: instructions in all, instructions up to the first
cp.async (LDGSTS, the window's first column copies), the global loads
and the barriers and shuffles before it, the mnemonics that differ, and
ptxas' registers, stack and spills of each.  The prologues themselves are
written to chiprun_out/walk_c_sass.txt.  It measures no time: it says
what the kLanes start adds before the walk's first copy, not what that
costs.

  python3 scripts/torch_walk_c_sass.py

Needs nvcc and cuobjdump (CUDA_HOME or /usr/local/cuda); the JSON printed
last holds every count.
"""

from __future__ import annotations

import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(HERE, "longreadmapper_tpu_torch", "csrc")
OUT = os.path.join(HERE, "chiprun_out")
INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
KERNEL = re.compile(r"walk_c_kernel\w*?I([si])Lb([01])E")


def tool(name: str) -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", name)):
            return os.path.join(root, "bin", name)
    found = shutil.which(name)
    if not found:
        raise SystemExit(f"torch_walk_c_sass.py needs {name}")
    return found


def functions(sass: str) -> dict:
    """{mangled name: [instruction text]} of cuobjdump -sass's output."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = INSN.search(line)
            if m:
                out[name].append(m.group(1))
    return out


def mnemonic(insn: str) -> str:
    parts = insn.split()
    if parts and parts[0].startswith("@"):
        parts = parts[1:]
    return parts[0] if parts else ""


def summary(insns: list) -> dict:
    ops = [mnemonic(x) for x in insns]
    first = next((k for k, op in enumerate(ops) if op.startswith("LDGSTS")),
                 len(ops))
    head = ops[:first]
    return dict(
        instructions=len(ops), before_first_cp_async=first,
        global_loads_before=sum(op.startswith("LDG") for op in head),
        global_stores_before=sum(op.startswith("STG") for op in head),
        shuffles_before=sum(op.startswith("SHFL") for op in head),
        barriers_before=sum(op.startswith(("BAR", "WARPSYNC"))
                            for op in head),
        mnemonics=collections.Counter(ops))


def main() -> int:
    nvcc, cuobjdump = tool("nvcc"), tool("cuobjdump")
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "walk.cubin")
        build = subprocess.run(
            [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
             "-O3", "-std=c++17", "-Xptxas", "-v", "-I", CSRC, "-o", cubin,
             os.path.join(CSRC, "walk.cu")],
            capture_output=True, text=True, check=True)
        sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                              text=True, check=True).stdout
    # ptxas -v: "Compiling entry function '<name>'" then its usage lines
    usage, name = {}, None
    for line in build.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "stack frame" in line):
            usage[name] = usage.get(name, "") + line.split(":", 1)[-1].strip()
    kernels = {}
    for fname, insns in functions(sass).items():
        m = KERNEL.search(fname)
        if m:
            key = ("int16" if m.group(1) == "s" else "int32",
                   m.group(2) == "1")
            kernels[key] = (fname, insns)
    if len(kernels) != 4:
        raise SystemExit(f"found {len(kernels)} walk_c_kernel instances, "
                         "not 4")
    out = {}
    with open(os.path.join(OUT, "walk_c_sass.txt"), "w") as f:
        for et in ("int16", "int32"):
            res = {}
            for lanes in (True, False):
                fname, insns = kernels[(et, lanes)]
                s = summary(insns)
                tag = "lanes" if lanes else "given"
                f.write(f"== {et} {tag}: {fname}\n")
                f.write("\n".join(insns[:s["before_first_cp_async"] + 1]))
                f.write("\n\n")
                res[tag] = dict(s, ptxas=usage.get(fname, ""))
            a, b = res["lanes"].pop("mnemonics"), res["given"].pop(
                "mnemonics")
            res["mnemonics_lanes_minus_given"] = {
                k: a[k] - b[k] for k in sorted(set(a) | set(b))
                if a[k] != b[k]}
            out[et] = res
            print(f"[sass] walk_c_kernel {et}: {json.dumps(res)}",
                  flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
