"""VRL records as fixed-capacity struct-of-arrays buffers.

Counterpart of alvrl_tpu/integrators/vrl/vrl.py (VRLs, compact,
compact_device, load_ascii, save_ascii). A buffer holds a fixed number
of slots with a validity mask; the estimator normalises by the
traced-particle count.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class VRLs:
    start: torch.Tensor           # (N, 3) f32
    end: torch.Tensor             # (N, 3) f32
    power: torch.Tensor           # (N, 3) f32 radiant intensity along the segment
    valid: torch.Tensor           # (N,) bool
    particle_count: torch.Tensor  # () f32: traced particles (the normaliser)

    @property
    def capacity(self) -> int:
        return self.start.shape[0]


def compact(vrls: VRLs, capacity: int | None = None,
            slots_per_particle: int | None = None) -> VRLs:
    """Host-side compaction: valid VRLs packed to the front, truncated
    or zero-padded to `capacity`.

    Truncation drops WHOLE particles, since the estimator normalises by
    the particle count: with `slots_per_particle` (the tracer's max
    depth) the largest particle prefix that fits is kept and
    `particle_count` drops to it. Without it, an overfull buffer raises.
    """
    device = vrls.start.device
    valid = vrls.valid.cpu().numpy()
    idx = np.nonzero(valid)[0]
    particle_count = vrls.particle_count
    if capacity is None:
        capacity = int(len(idx))
    if len(idx) > capacity:
        if slots_per_particle is None:
            raise ValueError(
                f"{len(idx)} valid VRLs exceed capacity {capacity}; pass "
                "slots_per_particle so truncation can drop whole particles")
        per_particle = valid.reshape(-1, slots_per_particle).sum(axis=1)
        n_keep = int(np.searchsorted(np.cumsum(per_particle), capacity,
                                     side="right"))
        if n_keep == 0:
            raise ValueError("capacity smaller than one particle's VRLs")
        keep = np.zeros_like(valid)
        keep[: n_keep * slots_per_particle] = True
        idx = np.nonzero(valid & keep)[0]
        particle_count = torch.tensor(float(n_keep), dtype=torch.float32,
                                      device=device)
    sel = torch.as_tensor(idx[:capacity], dtype=torch.int64, device=device)
    pad = capacity - len(sel)

    def take(a):
        out = a[sel]
        return torch.cat([out, out.new_zeros((pad,) + tuple(a.shape[1:]))])

    new_valid = torch.zeros((capacity,), dtype=torch.bool, device=device)
    new_valid[: len(sel)] = True
    return VRLs(start=take(vrls.start), end=take(vrls.end),
                power=take(vrls.power), valid=new_valid,
                particle_count=particle_count)


def compact_device(vrls: VRLs, capacity: int, slots_per_particle: int):
    """compact(vrls, capacity, slots_per_particle) without a sync of the
    device: the same VRLs bit for bit, by prefix sums over the valid
    mask (per slot, and per particle for the truncation), always padded
    to `capacity` (ROADMAP C4: the JAX package's compact_device returns
    unpadded arrays and keeps no particle below one particle's VRLs).

    Returns (VRLs, too_small), too_small a () bool tensor on the
    device, true where compact raises "capacity smaller than one
    particle's VRLs" (the VRLs are then empty): the caller raises
    (raise_if_too_small) at its next sync."""
    valid = vrls.valid
    n_slots = valid.shape[0]
    if n_slots % slots_per_particle:
        raise ValueError(f"{n_slots} slots are not whole particles of "
                         f"{slots_per_particle}")
    per_particle = valid.reshape(-1, slots_per_particle).sum(dim=1)
    # whole particles whose VRLs fit: compact's searchsorted(right)
    n_keep = (torch.cumsum(per_particle, 0) <= capacity).sum()
    overfull = valid.sum() > capacity
    slot = torch.arange(n_slots, device=valid.device)
    kept = valid & (~overfull | (slot < n_keep * slots_per_particle))
    # output j takes the (j + 1)-th kept slot
    count = torch.cumsum(kept, 0)
    j = torch.arange(capacity, device=valid.device)
    src = torch.searchsorted(count, j + 1).clamp(max=n_slots - 1)
    new_valid = j < count[-1]

    def take(a):
        return torch.where(new_valid[:, None], a[src], 0.0)

    particle_count = torch.where(overfull, n_keep.to(torch.float32),
                                 vrls.particle_count)
    return (VRLs(start=take(vrls.start), end=take(vrls.end),
                 power=take(vrls.power), valid=new_valid,
                 particle_count=particle_count),
            overfull & (n_keep == 0))


def raise_if_too_small(too_small):
    """Raise compact's error where compact_device's flag is set (a sync)."""
    if bool(too_small):
        raise ValueError("capacity smaller than one particle's VRLs")


def save_ascii(vrls: VRLs, path: str):
    """The reference's ASCII VRL interchange format: one line per valid
    VRL, `x0 y0 z0 x1 y1 z1 r g b`."""
    s = vrls.start.cpu().numpy()
    e = vrls.end.cpu().numpy()
    p = vrls.power.cpu().numpy()
    v = vrls.valid.cpu().numpy()
    with open(path, "w") as f:
        for i in np.nonzero(v)[0]:
            f.write(" ".join(f"{x:.9g}" for x in (*s[i], *e[i], *p[i]))
                    + "\n")


def load_ascii(path: str, particle_count: float | None = None,
               device="cuda") -> VRLs:
    """Load the ASCII VRL format. The file does not store the particle
    count; like the reference, it defaults to the VRL count."""
    rows = torch.as_tensor(np.loadtxt(path, dtype=np.float32, ndmin=2),
                           device=device)
    n = len(rows)
    if particle_count is None:
        particle_count = float(n)
    return VRLs(
        start=rows[:, 0:3].contiguous(),
        end=rows[:, 3:6].contiguous(),
        power=rows[:, 6:9].contiguous(),
        valid=torch.ones((n,), dtype=torch.bool, device=device),
        particle_count=torch.tensor(float(particle_count),
                                    dtype=torch.float32, device=device),
    )
