"""Whether each kernel of another tree's kernel library compiles to the
same machine code (SASS) in this tree's: every function of the other
library (cuobjdump -sass), its instructions without their addresses,
encodings (whose relative call offsets move with the object's layout)
and symbol names, looked for among this library's function bodies.

    python alvrl_tpu_torch/scripts/sass_compare.py --root DIR
    python alvrl_tpu_torch/scripts/sass_compare.py [--root DIR] --record F
    python alvrl_tpu_torch/scripts/sass_compare.py --against F

builds both trees' libraries (each tree's ops._build, in a process of
its own) and prints one JSON object: the number of the other tree's
functions, how many of them have a body equal to one of this tree's,
and the names of those that have none; and this tree's functions whose
body is none of the other's (its new forms), their count and names.
With --record, it writes F, a JSON object of each function of the DIR
tree's library (this tree's without --root) and the SHA-256 of its body,
which missing(F), or --against F (one JSON object of the record's
function count and the missing names), later looks for in this tree's
library without the other tree at hand (chip_smoke.py holds the
earlier forms to the parent's so).
A change that keeps a kernel's code and only adds template parameters
(so its mangled name changes) counts as the same SASS. Needs nvcc and
cuobjdump beside it.
"""

from __future__ import annotations

import argparse
import hashlib
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


def _digest(body: str) -> str:
    return hashlib.sha256(body.encode()).hexdigest()


def _cuobjdump():
    from alvrl_tpu_torch.ops import _build

    return os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")


def missing(recorded_path: str) -> list:
    """The functions of a --record file whose body is in no function of
    this tree's kernel library (built if needed); [] when every recorded
    body is there."""
    from alvrl_tpu_torch.ops import _build

    _build.load_library()
    with open(recorded_path) as f:
        recorded = json.load(f)
    mine = {_digest(b) for b in functions(str(_build._library_path()),
                                          _cuobjdump()).values()}
    return sorted(n for n, d in recorded.items() if d not in mine)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", help="the other tree, whose functions are "
                    "looked for")
    ap.add_argument("--record", help="write the functions' body digests "
                    "of the --root tree (this tree without it) here")
    ap.add_argument("--against", help="a --record file whose functions are "
                    "looked for in this tree's library")
    args = ap.parse_args()
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.path.insert(0, here)
    if args.against:
        with open(args.against) as f:
            n = len(json.load(f))
        print(json.dumps({"functions": n, "missing": missing(args.against)}))
        return
    if args.record:
        root = os.path.abspath(args.root or here)
        fns = functions(library(root), _cuobjdump())
        with open(args.record, "w") as f:
            json.dump({n: _digest(b) for n, b in sorted(fns.items())}, f,
                      indent=0)
        print(json.dumps({"root": root, "functions": len(fns),
                          "record": args.record}))
        return
    if not args.root:
        ap.error("--root is required without --record")
    cuobjdump = _cuobjdump()
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
