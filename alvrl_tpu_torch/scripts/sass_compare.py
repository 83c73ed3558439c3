"""Whether each kernel of another tree's kernel library compiles to the
same machine code (SASS) in this tree's: every function of the other
library (cuobjdump -sass), its instructions without their addresses,
encodings (whose relative call offsets move with the object's layout)
and symbol names, looked for among this library's function bodies.

    python alvrl_tpu_torch/scripts/sass_compare.py --root DIR

builds both trees' libraries (each tree's ops._build, in a process of
its own) and prints one JSON object: the number of the other tree's
functions, how many of them have a body equal to one of this tree's,
and the names of those that have none; and this tree's functions whose
body is none of the other's (its new forms), their count and names.
A change that keeps a kernel's code and only adds template parameters
(so its mangled name changes) counts as the same SASS. Needs nvcc and
cuobjdump beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_COMMENT = re.compile(r"/\*.*?\*/")  # addresses, encodings (relocated)
_SYMBOL = re.compile(r"_Z\w+")


def library(root: str) -> str:
    """Build the kernel library of the tree at root; its path."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from alvrl_tpu_torch.ops import _build; "
            "_build.load_library(); print(_build._library_path())")
    out = subprocess.run([sys.executable, "-c", code, root],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def functions(lib: str, cuobjdump: str) -> dict:
    """{mangled name: SASS body without addresses and symbol names}."""
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name, body = {}, None, []
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            if name:
                out[name] = "\n".join(body)
            name, body = m[1], []
        elif name and line.strip():
            body.append(" ".join(_SYMBOL.sub("SYM", _COMMENT.sub(
                "", line)).split()))
    if name:
        out[name] = "\n".join(body)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="the other tree, whose functions are looked for")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    from alvrl_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    other = functions(library(os.path.abspath(args.root)), cuobjdump)
    mine = functions(library(here), cuobjdump)
    bodies, other_bodies = set(mine.values()), set(other.values())
    differ = [n for n in other if other[n] not in bodies]
    new = sorted(n for n in mine if mine[n] not in other_bodies)
    print(json.dumps({"root": os.path.abspath(args.root),
                      "functions": len(other),
                      "same_sass": len(other) - len(differ),
                      "differ": differ, "new": len(new),
                      "new_names": new}))


if __name__ == "__main__":
    main()
