"""Gather probes on one card: kernels 12-14 of the port.

Counterpart of scripts/probe_gather.py, which asked whether a dynamic
gather works inside a Pallas kernel on the TPU and how fast it is, at
its shapes: 128 x 128 float32 tables, int32 indices from
numpy.random.default_rng(0), 256 gathers per element, 50 timed calls.
The three gathers are CUDA kernels (csrc/probe_gather.cu):
  * lane_gather: out[i, j] = tbl[i, idx[i, j]], on a 128-entry table
    replicated over the rows (the JAX script's :42);
  * row_gather: out[i, j] = tbl[idx[i, j], j] (the transposed gather,
    :63);
  * gather_many: out[i, j] = the sum over k < reps, in k order, of
    tbl[i, (idx[i, j] + k) % cols] (the throughput probe, :79).
Each wrapper runs its kernel on CUDA tensors (or raises) and its plain
version (torch.take_along_dim) on CPU tensors, and counts its launches.

    python -m alvrl_tpu_torch.scripts.probe_gather

prints one JSON line: the card, both gathers' agreement with the plain
versions, and the many-gather probe's time and gathers/s. With no CUDA
device it fails.
"""

from __future__ import annotations

import ctypes
import functools
import json
import subprocess
import time

import numpy as np
import torch

from alvrl_tpu_torch.ops import _build

SIZE = 128    # rows and columns of the probes' tables
REPS = 256    # gathers per element of gather_many
N_ITER = 50   # timed calls of gather_many


def inputs(device="cuda"):
    """The JAX script's inputs, drawn in its order from default_rng(0):
    (the 128-entry table replicated over 128 rows, its indices, the
    (128, 128) table of the column gather, its indices)."""
    rs = np.random.default_rng(0)
    table_1d = rs.uniform(0, 1, SIZE).astype(np.float32)
    idx = rs.integers(0, SIZE, (SIZE, SIZE)).astype(np.int32)
    tbl0 = rs.uniform(0, 1, (SIZE, SIZE)).astype(np.float32)
    idx0 = rs.integers(0, SIZE, (SIZE, SIZE)).astype(np.int32)
    return tuple(torch.as_tensor(a, device=device) for a in (
        np.broadcast_to(table_1d, (SIZE, SIZE)).copy(), idx, tbl0, idx0))


def lane_gather_reference(tbl, idx):
    return torch.take_along_dim(tbl, idx.long(), dim=1)


def row_gather_reference(tbl, idx):
    return torch.take_along_dim(tbl, idx.long(), dim=0)


def gather_many_reference(tbl, idx, reps=REPS):
    """The sum over k < reps of tbl[i, (idx[i, j] + k) % cols], added in k
    order from 0, as the kernel adds."""
    acc = torch.zeros(tbl.shape, dtype=torch.float32, device=tbl.device)
    idx = idx.long()
    for k in range(reps):
        acc = acc + torch.take_along_dim(tbl, (idx + k) % tbl.shape[1], dim=1)
    return acc


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.load_library()
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.alvrl_lane_gather.argtypes = [p, p, i, i, p, p]
    lib.alvrl_row_gather.argtypes = [p, p, i, i, p, p]
    lib.alvrl_gather_many.argtypes = [p, p, i, i, i, p, p]
    for fn in (lib.alvrl_lane_gather, lib.alvrl_row_gather,
               lib.alvrl_gather_many):
        fn.restype = i
    lib.alvrl_error_string.argtypes = [i]
    lib.alvrl_error_string.restype = ctypes.c_char_p
    return lib


def _check(tbl, idx, axis_len):
    for name, t, dt in (("tbl", tbl, torch.float32), ("idx", idx, torch.int32)):
        if not isinstance(t, torch.Tensor) or t.dtype != dt:
            raise TypeError(f"{name} must be a {dt} tensor")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if idx.shape != tbl.shape or idx.device != tbl.device:
        raise ValueError("tbl and idx must have one shape and one device")
    if tbl.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {tbl.device}")
    lo, hi = (int(v) for v in torch.aminmax(idx))
    if lo < 0 or hi >= axis_len:
        raise ValueError(f"indices must lie in [0, {axis_len})")


def _launch(name, tbl, idx, *extra):
    """Kernel `name` of csrc/probe_gather.cu on checked inputs."""
    lib = _library()
    out = torch.empty_like(tbl)
    with torch.cuda.device(tbl.device):
        err = getattr(lib, name)(
            tbl.data_ptr(), idx.data_ptr(), *tbl.shape, *extra,
            out.data_ptr(), torch.cuda.current_stream(tbl.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.alvrl_error_string(err).decode()})")
    return out


def lane_gather(tbl, idx):
    """out[i, j] = tbl[i, idx[i, j]]: tbl (R, C) float32, idx (R, C)
    int32 in [0, C)."""
    _check(tbl, idx, tbl.shape[1])
    if tbl.device.type == "cpu":
        return lane_gather_reference(tbl, idx)
    out = _launch("alvrl_lane_gather", tbl, idx)
    lane_gather.launches += 1
    return out


lane_gather.launches = 0  # kernel launches, for showing that a run used the kernel


def row_gather(tbl, idx):
    """out[i, j] = tbl[idx[i, j], j]: tbl (R, C) float32, idx (R, C)
    int32 in [0, R)."""
    _check(tbl, idx, tbl.shape[0])
    if tbl.device.type == "cpu":
        return row_gather_reference(tbl, idx)
    out = _launch("alvrl_row_gather", tbl, idx)
    row_gather.launches += 1
    return out


row_gather.launches = 0


def gather_many(tbl, idx, reps=REPS):
    """out[i, j] = sum over k < reps, in k order, of tbl[i, (idx[i, j] +
    k) % C]: tbl (R, C) float32, idx (R, C) int32 in [0, C)."""
    _check(tbl, idx, tbl.shape[1])
    if reps < 0:
        raise ValueError("reps must be >= 0")
    if tbl.device.type == "cpu":
        return gather_many_reference(tbl, idx, reps)
    out = _launch("alvrl_gather_many", tbl, idx, reps)
    gather_many.launches += 1
    return out


gather_many.launches = 0


def main(device="cuda"):
    """The JAX script's probe on one card: both gathers against their
    plain versions, then gather_many timed over N_ITER calls after one
    warm-up (host clock to a synchronize, as the JAX script times).
    Returns and prints the result."""
    if not torch.cuda.is_available():
        raise SystemExit("probe_gather: no CUDA device")
    tbl, idx, tbl0, idx0 = inputs(device)
    lane_ok = torch.equal(lane_gather(tbl, idx),
                          lane_gather_reference(tbl, idx))
    row_ok = torch.equal(row_gather(tbl0, idx0),
                         row_gather_reference(tbl0, idx0))
    gather_many(tbl, idx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_ITER):
        out = gather_many(tbl, idx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = SIZE * SIZE * REPS * N_ITER
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    result = {"card": card, "lane_gather_equal": lane_ok,
              "row_gather_equal": row_ok,
              "gather_many_us_per_call": dt / N_ITER * 1e6,
              "gathers_per_s": total / dt, "output_mean": float(out.mean())}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
