#!/usr/bin/env python3
"""gact_walk_kernel's int16 instantiation against another checkout's
kernel in the card's machine code: each checkout's csrc/walk.cu built
for sm_90a as a cubin (nvcc -cubin, the flags of native_build), its SASS
read with cuobjdump, and the int16 kernel (`gact_walk_kernel<short>`, or
the untemplated kernel of a checkout before the entry width) of each
compared instruction by instruction, branch targets and addresses
included; ptxas' registers, stack and spills of each, and of the int32
instantiation where there is one.  It measures no time: equal SASS is
equal code.

  python3 scripts/torch_gact_walk_sass.py --base DIR

Needs nvcc and cuobjdump (CUDA_HOME or /usr/local/cuda); the JSON printed
last holds the verdict and every count; both listings go to
gact_walk_sass.txt in the output folder of scripts/torch_walk_c_sass.py.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_walk_c_sass import OUT, functions, tool  # noqa: E402

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GACT = re.compile(r"gact_walk_kernel(I([si])E)?")


def build(checkout: str, tmp: str, tag: str):
    """{"int16" | "int32": (mangled name, instructions, ptxas usage)} of
    checkout's gact_walk_kernel instantiations."""
    nvcc, cuobjdump = tool("nvcc"), tool("cuobjdump")
    csrc = os.path.join(checkout, "longreadmapper_tpu_torch", "csrc")
    cubin = os.path.join(tmp, tag + ".cubin")
    built = subprocess.run(
        [nvcc, "-cubin", "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
         "-std=c++17", "-Xptxas", "-v", "-I", csrc, "-o", cubin,
         os.path.join(csrc, "walk.cu")],
        capture_output=True, text=True, check=True)
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    usage, name = {}, None
    for line in built.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "stack frame" in line):
            usage[name] = usage.get(name, "") + line.split(":", 1)[-1].strip()
    out = {}
    for fname, insns in functions(sass).items():
        m = GACT.search(fname)
        if m:
            et = "int32" if m.group(2) == "i" else "int16"
            out[et] = (fname, insns, usage.get(fname, ""))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", required=True)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        base = build(os.path.abspath(args.base), tmp, "base")
        new = build(HERE, tmp, "new")
    (bn, bi, bu), (nn, ni, nu) = base["int16"], new["int16"]
    diff = [k for k in range(max(len(bi), len(ni)))
            if k >= len(bi) or k >= len(ni) or bi[k] != ni[k]]
    with open(os.path.join(OUT, "gact_walk_sass.txt"), "w") as f:
        for tag, (fname, insns, _) in (("base", base["int16"]),
                                       ("new", new["int16"])):
            f.write(f"== {tag}: {fname}\n" + "\n".join(insns) + "\n\n")
    res = dict(equal=not diff, base=dict(name=bn, instructions=len(bi),
                                         ptxas=bu),
               new=dict(name=nn, instructions=len(ni), ptxas=nu),
               first_differences=[[k, bi[k] if k < len(bi) else None,
                                   ni[k] if k < len(ni) else None]
                                  for k in diff[:10]],
               differing=len(diff))
    if "int32" in new:
        res["new_int32"] = dict(name=new["int32"][0],
                                instructions=len(new["int32"][1]),
                                ptxas=new["int32"][2])
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
