#!/usr/bin/env python3
"""Time the two ways to build the port's kernel library from csrc/*.cu:

- parallel: one ``nvcc -c`` per source, all started together, then one
  ``nvcc -shared`` link (what ``vision_transformers_tpu_torch/ops/_build.py``
  does);
- single: one ``nvcc -shared`` call over all sources.

Both use ``_build``'s flags and write into a temporary directory under the
package's ``_build/``; the order is parallel, single, single, parallel, so
that a warm file cache favours neither.  Prints the wall seconds of each
build and one JSON line.  Needs nvcc (the machine with the card); imports no
JAX.

    python3 scripts/time_port_build.py
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    sys.path.insert(0, ROOT)
    from vision_transformers_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    sources = [str(p) for p in sorted(_build._CSRC.glob("*.cu"))]
    _build._BUILD_DIR.mkdir(parents=True, exist_ok=True)
    times = {"parallel": [], "single": []}
    with tempfile.TemporaryDirectory(dir=_build._BUILD_DIR) as tmp:
        def parallel(i):
            objs = [os.path.join(tmp, f"{i}.{os.path.basename(s)}.o") for s in sources]
            _build._run_all([[nvcc, *_build._FLAGS, "-c", "-o", o, s]
                             for o, s in zip(objs, sources)])
            _build._run_all([[nvcc, "-shared", "-o", os.path.join(tmp, f"p{i}.so"), *objs]])

        def single(i):
            _build._run_all([[nvcc, *_build._FLAGS, "-shared", "-o",
                              os.path.join(tmp, f"s{i}.so"), *sources]])

        for i, (name, fn) in enumerate((("parallel", parallel), ("single", single),
                                        ("single", single), ("parallel", parallel))):
            t0 = time.perf_counter()
            fn(i)
            times[name].append(time.perf_counter() - t0)
            print(f"build {name}: {times[name][-1]:.2f} s ({len(sources)} sources, "
                  f"{os.cpu_count()} CPUs)", flush=True)
    print(json.dumps({"sources": len(sources), "cpus": os.cpu_count(), **times}))


if __name__ == "__main__":
    main()
