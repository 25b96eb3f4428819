"""Compare the SASS of this tree's CUDA libraries with another tree's,
function by function.

Builds each named source (``csrc/<stem>.cu``) in this tree and in
``--other`` (a copy of another commit, e.g. ``git archive`` of the parent
unpacked under ``.smoke_archive/``), dumps both libraries with ``cuobjdump
-sass``, drops the anonymous namespace's hash from the function names (it
follows the source's path, so a kernel whose body moved to a header keeps
its name) and the addresses in front of the instructions, and prints one
JSON line a source: the functions found in only one tree, and those whose
instructions differ (with the first differing instruction).  A change that
should leave a kernel alone shows it here: ``"differ": []``.  Then the
card's name and power limit, as nvidia-smi gives them.

Run, on a machine with the CUDA toolkit: ``python -m
dgq_tpu_torch.scripts.sass_diff --other DIR [--sources STEM ...]``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

from dgq_tpu_torch.ops import _cuda

# the anonymous namespace: a hash, the source's name and "_cu_", then a hex hash or (seen for
# s8_gemm.cu and s4_gemv.cu) the source's name again
_NAMESPACE = re.compile(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?)_cu_(?:[0-9a-f]{8}|\1)")


def functions(sass: str) -> dict:
    """{function name without the namespace hash: its instructions} of a
    ``cuobjdump -sass`` listing."""
    out, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = _NAMESPACE.sub("", m.group(1))
            out[fn] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if fn is not None and m:
            out[fn].append(m.group(1))
    return out


def _libraries(root: Path, stems) -> dict:
    """{stem: its built library} in the tree at ``root``, built by that
    tree's own ``_cuda`` (one nvcc a source, all at once) in a process of
    its own."""
    code = ("import json, sys; from dgq_tpu_torch.ops import _cuda; "
            f"stems = {list(stems)!r}; _cuda.build(stems); "
            "print(json.dumps({s: str(_cuda._lib_path(s)) for s in stems}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         check=True, timeout=900)
    return {s: Path(p) for s, p in json.loads(res.stdout.strip().splitlines()[-1]).items()}


def _sass(lib: Path) -> str:
    cuobjdump = Path(_cuda._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def compare(stem: str, mine: dict, theirs: dict) -> dict:
    differ = []
    for fn in sorted(set(mine) & set(theirs)):
        a, b = mine[fn], theirs[fn]
        if a != b:
            i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
            differ.append({"function": fn, "instructions": [len(a), len(b)], "first": i,
                           "this": a[i] if i < len(a) else None,
                           "other": b[i] if i < len(b) else None})
    return {"source": stem, "functions": len(mine), "same": len(set(mine) & set(theirs)) -
            len(differ), "differ": differ, "only_this": sorted(set(mine) - set(theirs)),
            "only_other": sorted(set(theirs) - set(mine))}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, help="the root of the other tree")
    ap.add_argument("--sources", nargs="+", default=sorted(set(_cuda.SOURCES.values())),
                    help="csrc stems (default: every source of this tree)")
    args = ap.parse_args(argv)
    here, other = _cuda.PKG_DIR.parent, Path(args.other).resolve()
    rows = []
    mine, theirs = _libraries(here, args.sources), _libraries(other, args.sources)
    for stem in args.sources:
        rows.append(compare(stem, functions(_sass(mine[stem])), functions(_sass(theirs[stem]))))
        print(json.dumps(rows[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed")
    return rows


if __name__ == "__main__":
    main()
