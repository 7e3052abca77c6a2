"""The serving mesh (``repro.launch.mesh``): ``dp`` data replicas x ``mp``
model ranks, each rank on an explicit device, and the collectives the
tensor-parallel step uses.

The reference's mesh is single-controller: one process runs ``shard_map``
over a ``(data, model)`` device mesh.  The port keeps that shape in one
process: a replica's ``mp`` ranks are driven in lockstep, block by block,
and a collective is a plain function over the per-rank tensors
(:func:`all_reduce_sum` is the reference's ``psum``, :func:`all_gather`
its tiled ``all_gather``).  The same code then runs whether the ranks share
one device (the CPU in tests, one card) or sit on several.  Nothing here
uses ``torch.distributed``: a device may hold several ranks.

:func:`make_mesh` places one rank per visible device unless the caller
names the devices; with fewer devices than ranks it raises, as
``make_host_mesh`` asserts, so a device is never shared silently:

    make_mesh(2, 2, ["cpu"] * 4)      # four ranks on the CPU
    make_mesh(1, 2, ["cuda:0"] * 2)   # two ranks on one card
"""
from __future__ import annotations

import dataclasses

import torch

AXES = ("data", "model")


def _normal(device) -> torch.device:
    """``device`` with an explicit index on CUDA (``cuda`` -> ``cuda:N``,
    the current device), so equal devices compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def visible_devices(device_type: str) -> list[torch.device]:
    """The devices of one type a mesh may place ranks on by default: every
    visible CUDA device, or the one CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``dp x mp`` ranks on ``devices`` (rank ``(i, r)`` of replica ``i`` at
    ``devices[i * mp + r]``), axes ``("data", "model")``."""

    dp: int
    mp: int
    devices: tuple[torch.device, ...]

    axis_names = AXES

    def __post_init__(self):
        if self.dp < 1 or self.mp < 1:
            raise ValueError(f"mesh axes must be >= 1, got dp={self.dp} mp={self.mp}")
        if len(self.devices) != self.dp * self.mp:
            raise ValueError(f"a {self.dp}x{self.mp} mesh places {self.dp * self.mp} ranks, "
                             f"got {len(self.devices)} devices")

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dp, self.mp)

    def device(self, replica: int, rank: int) -> torch.device:
        return self.devices[replica * self.mp + rank]

    def replica_devices(self, replica: int) -> list[torch.device]:
        """The devices of replica ``replica``'s ranks, in rank order."""
        return list(self.devices[replica * self.mp:(replica + 1) * self.mp])


def make_mesh(dp: int, mp: int, devices=None, *, device_type: str = "cuda") -> Mesh:
    """A ``dp x mp`` mesh on ``devices`` (``dp * mp`` of them, repeats
    allowed), or by default one rank per visible device of
    ``device_type``; raises when fewer are visible than ranks."""
    n = dp * mp
    if devices is None:
        visible = visible_devices(device_type)
        if len(visible) < n:
            raise ValueError(
                f"a {dp}x{mp} mesh needs {n} devices, {len(visible)} {device_type} device(s) visible; "
                f"pass a device list (e.g. [{str(visible[0])!r}] * {n}) to place several ranks on one device"
            )
        devices = visible[:n]
    return Mesh(dp, mp, tuple(_normal(d) for d in devices))


def data_axes(mesh: Mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes (the reference's ``("pod", "data")``
    where present; the serving mesh has ``data`` alone)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def all_reduce_sum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reference's ``psum`` over the model axis: every rank gets the sum
    of every rank's part, added in rank order in the parts' dtype, on its
    own device (ranks that share a device share the one sum)."""
    sums: dict[torch.device, torch.Tensor] = {}
    out = []
    for p in parts:
        acc = sums.get(p.device)
        if acc is None:
            acc = parts[0].to(p.device)
            for q in parts[1:]:
                acc = acc + q.to(p.device)
            sums[p.device] = acc
        out.append(acc)
    return out


def all_gather(parts: list[torch.Tensor], dim: int) -> torch.Tensor:
    """The reference's tiled ``all_gather``: the parts concatenated in rank
    order along ``dim``, on the first rank's device (where the host reads
    the step's logits)."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=dim)
