"""Wall time of each kernel source's nvcc compile, all started together as
ops._build.load_library starts them, with the library's flags and then
with nvcc's --split-compile (and ptxas's), and whether each object's
SASS (cuobjdump -sass) is the same as with the library's flags:

    python -m alvrl_tpu_torch.scripts.build_times

Needs nvcc (CUDA_HOME or PATH) and cuobjdump beside it; builds into a
temporary directory, not into the library's.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import time

from alvrl_tpu_torch.ops import _build

VARIANTS = {
    "split": ["--split-compile=0"],
    "split_ptxas": ["--split-compile=0", "-Xptxas", "--split-compile=0"],
}


def batch(nvcc, srcs, tag, extra, out):
    """Compile every source at once with the library's flags plus
    `extra`; print the wall time and each source's; True if all built."""
    t0 = time.time()
    pending = [(src.stem, subprocess.Popen(
        [nvcc, *_build.COMPILE_FLAGS, *extra, "-o",
         os.path.join(out, f"{src.stem}.{tag}.o"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src in srcs]
    times, ok = {}, True
    while pending:
        for stem, proc in list(pending):
            if proc.poll() is None:
                continue
            times[stem] = round(time.time() - t0, 1)
            if proc.returncode != 0:
                ok = False
                print(tag, stem, "rc", proc.returncode,
                      proc.stderr.read()[-800:], flush=True)
            pending.remove((stem, proc))
        time.sleep(0.2)
    print(tag, "wall", round(time.time() - t0, 1), "per source", times,
          flush=True)
    return ok


def main():
    nvcc = _build._nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    srcs = sorted(_build.CSRC_DIR.glob("*.cu"))
    with tempfile.TemporaryDirectory() as out:
        batch(nvcc, srcs, "plain", [], out)
        for tag, extra in VARIANTS.items():
            if not batch(nvcc, srcs, tag, extra, out):
                continue
            same = []
            for src in srcs:
                sass = [subprocess.run(
                    [cuobjdump, "-sass", os.path.join(out, f"{src.stem}.{t}.o")],
                    capture_output=True, text=True).stdout
                    for t in ("plain", tag)]
                same.append(f"{src.stem} {sass[0] == sass[1]}")
            print(tag, "SASS equal:", "; ".join(same), flush=True)


if __name__ == "__main__":
    main()
