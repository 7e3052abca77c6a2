"""The mesh (``repro.launch.mesh``): ``dp`` data replicas x ``mp`` model
ranks, each rank on an explicit device, and the collectives the
tensor-parallel serving and training steps use.

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

The training half holds arrays as :class:`Sharded` leaves (the
reference's sharded ``jax.Array``: a part a rank, placed by a partition
spec, :func:`shard_tree` / :func:`gather_tree`) and adds the collectives a
sharded train step needs: :func:`gather_axis` (the ZeRO all_gather over
the data axis; autograd's backward of it is the reduce-scatter),
:func:`all_to_all` over the model axis (the MoE's exchange) and
:func:`sum_replicated_grads` (the data-axis gradient sum), each a plain
function in rank order.
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


# -- the training half: sharded arrays and their collectives -------------------------


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a partition spec (one
    entry a dimension: a mesh axis name, a tuple of them, or None)."""

    mesh: Mesh
    spec: tuple


def _spec_axes(entry, mesh: Mesh) -> tuple[str, ...]:
    """The mesh axes a spec entry splits its dimension over (axes the mesh
    lacks, the reference's ``"pod"``, count as size 1)."""
    if entry is None:
        return ()
    names = (entry,) if isinstance(entry, str) else tuple(entry)
    for n in names:
        if n not in ("pod", *mesh.axis_names):
            raise ValueError(f"a partition spec names the axis {n!r}; the mesh has {mesh.axis_names}")
    return tuple(n for n in names if n in mesh.axis_names)


def _axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.dp if axis == "data" else mesh.mp


class Sharded:
    """A logical array held as per-rank parts on a mesh (the reference's
    sharded ``jax.Array``).  ``parts[i * mp + r]`` is rank ``(i, r)``'s
    block, on ``mesh.device(i, r)``: each dimension that ``spec`` maps to
    mesh axes is cut into contiguous blocks in rank order, every other
    dimension is whole, so the parts of ranks that differ only along an
    axis the spec does not name hold the same values (a replicated leaf
    has ``dp * mp`` copies).  Stored leaves own their parts; the results
    of a gather share one tensor among the ranks of a device."""

    __slots__ = ("parts", "spec", "mesh", "shape")

    def __init__(self, parts: list, spec, mesh: Mesh, shape):
        spec = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
        if len(parts) != mesh.dp * mesh.mp or len(spec) != len(shape):
            raise ValueError(f"{len(parts)} parts of spec {spec} for a {mesh.dp}x{mesh.mp} mesh and shape {shape}")
        self.parts, self.spec, self.mesh, self.shape = list(parts), spec, mesh, tuple(shape)

    def __repr__(self) -> str:
        return f"Sharded(shape={self.shape}, spec={self.spec}, dtype={self.dtype}, mesh={self.mesh.shape})"

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    def part(self, i: int, r: int) -> torch.Tensor:
        return self.parts[i * self.mesh.mp + r]

    def axes(self) -> set[str]:
        """The mesh axes the leaf is sharded over."""
        return {a for e in self.spec for a in _spec_axes(e, self.mesh)}

    def block(self, i: int, r: int) -> tuple[int, int]:
        """Which block rank ``(i, r)`` holds, as (data index, model index),
        0 along an axis the leaf is replicated over."""
        axes = self.axes()
        return (i if "data" in axes else 0, r if "model" in axes else 0)

    def unique_parts(self) -> list[torch.Tensor]:
        """One part per block, in rank order: every element once (the
        copies of a replicated leaf counted once)."""
        return [self.parts[group[0]] for group in self.replica_groups()]

    def replica_groups(self) -> list[list[int]]:
        """The part indices that hold each block, in rank order."""
        groups: dict[tuple[int, int], list[int]] = {}
        for i in range(self.mesh.dp):
            for r in range(self.mesh.mp):
                groups.setdefault(self.block(i, r), []).append(i * self.mesh.mp + r)
        return list(groups.values())

    def map(self, fn) -> "Sharded":
        """``fn`` over the parts (elementwise functions only: the spec and
        shape stay)."""
        return Sharded([fn(p) for p in self.parts], self.spec, self.mesh, self.shape)

    def layer(self, i: int) -> "Sharded":
        """Layer ``i`` of a stacked ``[L, ...]`` leaf (its leading axis whole)."""
        return Sharded([p[i] for p in self.parts], self.spec[1:], self.mesh, self.shape[1:])


def _block_slices(shape, spec, mesh: Mesh, i: int, r: int) -> tuple:
    out = []
    for n, entry in zip(shape, spec):
        axes = _spec_axes(entry, mesh)
        count, index = 1, 0
        for a in axes:
            count, index = count * _axis_size(mesh, a), index * _axis_size(mesh, a) + (i if a == "data" else r)
        if n % count:
            raise ValueError(f"a dimension of {n} does not split into {count} blocks (shape {tuple(shape)}, spec {spec})")
        out.append(slice(index * (n // count), (index + 1) * (n // count)))
    return tuple(out)


def shard_array(a: torch.Tensor, sharding: NamedSharding) -> Sharded:
    """``jax.device_put(a, sharding)``: each rank's block of ``a`` copied
    onto its device, detached (every part a leaf with its own storage, so a
    replicated leaf's copies are updated independently, as on separate
    devices)."""
    mesh = sharding.mesh
    spec = tuple(sharding.spec) + (None,) * (a.dim() - len(tuple(sharding.spec)))
    parts = []
    for i in range(mesh.dp):
        for r in range(mesh.mp):
            blk = a.detach()[_block_slices(a.shape, spec, mesh, i, r)]
            dev = mesh.device(i, r)
            parts.append(blk.to(dev, copy=True).contiguous() if blk.device == dev else blk.to(dev).contiguous())
    return Sharded(parts, spec, mesh, tuple(a.shape))


def gather_array(x: Sharded, device=None) -> torch.Tensor:
    """The whole array, each block taken from its first holder, on
    ``device`` (default: the first rank's)."""
    dev = torch.device(device) if device is not None else x.parts[0].device
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    axes = x.axes()
    for i in range(x.mesh.dp if "data" in axes else 1):
        for r in range(x.mesh.mp if "model" in axes else 1):
            out[_block_slices(x.shape, x.spec, x.mesh, i, r)] = x.part(i, r).detach().to(dev)
    return out


def shard_tree(tree, specs, mesh: Mesh):
    """A tree of tensors as :class:`Sharded` leaves by a matching tree of
    partition specs (``param_shardings``, ``param_shardings_opt``); a 0-d
    leaf (the optimizer's step count) stays one tensor on the first
    rank's device, the controller's."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    if hasattr(tree, "_fields"):  # NamedTuple (AdamWState)
        return type(tree)(*(shard_tree(getattr(tree, f), getattr(specs, f), mesh) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh) for v, s in zip(tree, specs))
    if tree is None:
        return None
    if tree.dim() == 0:
        return tree.to(mesh.devices[0], copy=True)
    return shard_array(tree, NamedSharding(mesh, () if specs is None else tuple(specs)))


def gather_tree(tree, device=None):
    """A tree's :class:`Sharded` leaves as whole tensors (on ``device``,
    default each leaf's first rank's); other leaves as they are."""
    if isinstance(tree, Sharded):
        return gather_array(tree, device)
    if isinstance(tree, dict):
        return {k: gather_tree(v, device) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(gather_tree(getattr(tree, f), device) for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, device) for v in tree)
    return tree


def gather_axis(x: Sharded, axis: str) -> Sharded:
    """``x`` gathered over one mesh axis (the ZeRO all_gather over
    ``"data"``; over ``"model"``, a tensor-parallel rank's whole copy):
    the blocks that differ along ``axis`` concatenated in rank order along
    the dimension the spec maps to it, one result per device (ranks that
    share a device share it).  Autograd's backward of the concatenation
    is the reduce-scatter: each block's gradient is the sum over the
    ranks that used the gathered tensor, accumulated into the block."""
    dims = [d for d, e in enumerate(x.spec) if axis in _spec_axes(e, x.mesh)]
    if not dims:
        return x
    (dim,) = dims
    if _spec_axes(x.spec[dim], x.mesh) != (axis,):
        raise NotImplementedError(f"gathering {axis!r} out of the multi-axis spec entry {x.spec[dim]!r}")
    mesh = x.mesh
    out: list = [None] * len(x.parts)
    cache: dict = {}
    for i in range(mesh.dp):
        for r in range(mesh.mp):
            peers = ([x.part(j, r) for j in range(mesh.dp)] if axis == "data"
                     else [x.part(i, j) for j in range(mesh.mp)])
            dev = mesh.device(i, r)
            key = (tuple(id(p) for p in peers), dev)
            if key not in cache:
                cache[key] = torch.cat([p.to(dev) for p in peers], dim=dim)
            out[i * mesh.mp + r] = cache[key]
    spec = tuple(None if d == dim else e for d, e in enumerate(x.spec))
    return Sharded(out, spec, mesh, x.shape)


def all_to_all(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The reference's ``all_to_all`` over the model axis (``split_axis=0,
    concat_axis=0, tiled=False`` on an ``[M * c, ...]`` buffer viewed as
    ``[M, c, ...]``): rank ``r`` receives block ``r`` of every rank's
    buffer, concatenated in rank order, on its own device."""
    M = len(parts)
    c = parts[0].shape[0] // M
    return [torch.cat([p[r * c:(r + 1) * c].to(parts[r].device) for p in parts]) for r in range(M)]


def sum_replicated_grads(x: Sharded) -> None:
    """The gradient sum over the axes ``x`` is replicated along (the data
    axis for a leaf ZeRO does not shard, the model axis for one tensor
    parallelism does not split): every part that holds a block gets the
    sum of their gradients, added in rank order (:func:`all_reduce_sum`),
    written into its own ``.grad``."""
    for group in x.replica_groups():
        if len(group) == 1:
            continue
        sums = all_reduce_sum([x.parts[k].grad for k in group])
        for k, s in zip(group, sums):
            x.parts[k].grad.copy_(s)
