#!/usr/bin/env python3
"""Compare the compiled kernels of two source trees, source file by source
file: whether each kernel of one tree compiles to the same SASS as a kernel
of the other.

    python3 scripts/diff_sass.py _archive_check/base .

Each tree's library is built by its own ``ops/_build.build()`` (in a
process of its own, so that each imports its own package; a tree built
before is reused), then ``cuobjdump -sass`` lists its functions.  A
function's body is its instruction text, without addresses and encodings;
its source file is read from its name.  For each file the script prints how
many bodies the two trees share, and each body found in only one tree under
its function's name, so that a change that leaves a file's kernels as they
were shows as "same" for that file, whatever its templates are called.
Prints one JSON line.  Needs nvcc (and cuobjdump beside it); imports no JAX.
"""

import collections
import json
import os
import re
import subprocess
import sys

BUILD = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "from vision_transformers_tpu_torch.ops import _build; "
         "print(_build.find_nvcc()); print(_build.build()._name)")


def library(tree):
    """(the tree's built library, its nvcc)."""
    out = subprocess.run([sys.executable, "-c", BUILD, os.path.abspath(tree)],
                         capture_output=True, text=True, check=True).stdout
    nvcc, lib = out.strip().splitlines()[-2:]
    return lib, nvcc


def bodies(lib, cuobjdump):
    """{source file: Counter(body → count)} and {body: function name}."""
    sass = subprocess.run([cuobjdump, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    per_file, names, name, lines = collections.defaultdict(collections.Counter), {}, None, []

    def close():
        if name:
            m = re.search(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?)_cu_[0-9a-f]+", name)
            body = "\n".join(lines)
            per_file[(m.group(1) + ".cu") if m else "?"][body] += 1
            names.setdefault(body, name)

    for line in sass.splitlines():
        if "Function : " in line:
            close()
            name, lines = line.split("Function : ")[1].strip(), []
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            lines.append(m.group(1))
    close()
    return per_file, names


def main() -> None:
    a, b = sys.argv[1:3]
    (lib_a, nvcc), (lib_b, _) = library(a), library(b)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    (fa, na), (fb, nb) = bodies(lib_a, cuobjdump), bodies(lib_b, cuobjdump)
    report = {}
    for f in sorted(set(fa) | set(fb)):
        both = sum((fa[f] & fb[f]).values())
        only_a = [na[x] for x in (fa[f] - fb[f])]
        only_b = [nb[x] for x in (fb[f] - fa[f])]
        report[f] = {"same": both, "only_" + a: only_a, "only_" + b: only_b}
        state = "same" if not only_a and not only_b else "differs"
        print(f"{f}: {state}: {both} kernels compile the same"
              + "".join(f"\n  only in {a}: {n[:140]}" for n in only_a)
              + "".join(f"\n  only in {b}: {n[:140]}" for n in only_b))
    print(json.dumps(report))


if __name__ == "__main__":
    main()
