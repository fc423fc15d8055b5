"""Sharding of the registration hot path over a device mesh.

Twin of ``glim_tpu/parallel/sharded.py``. JAX's ``shard_map`` is driven by
one process for every device; so is this: a ``Mesh`` is an ordered tuple of
``torch.device``s and an axis name, and a sharded call splits the sharded
axis into one contiguous slice per mesh entry, runs each slice on its
entry's device, and then either sums the partial systems on the first
device in shard order (``psum``'s twin) or concatenates them in order
(``out_specs=P(axis)``'s twin). What every shard reads whole (a voxel map,
a target cloud) is copied to each distinct device once a call.

A mesh may name one device several times: eight entries that are all
``torch.device("cpu")`` are the tests' stand-in for JAX's eight virtual CPU
devices, and eight entries on ``cuda:0`` hold the shard boundaries at full
size on one card. No process group is used: the reductions are a few
hundred bytes a factor.

A sharded axis whose length the mesh size does not divide raises
``ValueError``, as ``shard_map`` does; nothing is padded.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional, Sequence, Tuple

import torch
from torch.func import vmap

from glim_tpu_torch.ops import gicp, lie, solver
from glim_tpu_torch.ops.voxelmap import GaussianVoxelMap, lookup_table


@dataclass(frozen=True)
class Mesh:
    """Devices in shard order along one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "points"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "points",
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh over ``devices`` (default: every CUDA device), or over the
    first ``n_devices`` of them. Without a card and without ``devices`` it
    raises, as ``GlimTorch`` does; asking for more devices than there are
    raises too."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices= "
                               "to build a mesh of other devices")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if not 1 <= n <= len(devs):
        raise ValueError(f"make_mesh: {n} devices asked for, {len(devs)} available")
    return Mesh(devs[:n], axis)


def shard_slices(mesh: Mesh, x: torch.Tensor, what: str) -> list:
    """x's leading axis in mesh.size contiguous slices, each on its device;
    a length the mesh size does not divide raises ValueError (``what``
    names the caller)."""
    n = int(x.shape[0])
    if n % mesh.size:
        raise ValueError(f"{what}: axis '{mesh.axis}' of length {n} is not divisible by "
                         f"the mesh size {mesh.size}")
    k = n // mesh.size
    return [x[i * k:(i + 1) * k].to(dev) for i, dev in enumerate(mesh.devices)]


def replicas(mesh: Mesh, make) -> dict:
    """``make(device)`` once for each distinct device of the mesh."""
    return {dev: make(dev) for dev in dict.fromkeys(mesh.devices)}


def _voxelmap_to(vm: GaussianVoxelMap, dev) -> GaussianVoxelMap:
    return GaussianVoxelMap(*(getattr(vm, f.name).to(dev) for f in fields(GaussianVoxelMap)))


def _psum(parts, dev) -> gicp.FactorSystem:
    """Field-wise sum of the shards' systems on ``dev``, in shard order."""
    out = []
    for xs in zip(*parts):
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = acc + x.to(dev)
        out.append(acc)
    return gicp.FactorSystem(*out)


def _source_shards(mesh: Mesh, what: str, *xs):
    """(device, shard of each of ``xs``) for every mesh entry."""
    return zip(mesh.devices, *(shard_slices(mesh, x, what) for x in xs))


def _map_replicas(mesh: Mesh, vm: GaussianVoxelMap) -> dict:
    """device -> (the voxel map there, its lookup table)."""
    def make(dev):
        v = _voxelmap_to(vm, dev)
        return v, lookup_table(v)
    return replicas(mesh, make)


def _vgicp_shards(mesh, maps, T_target, T_source, src_pts, src_covs, src_mask):
    """Per-shard VGICP systems against ``maps`` (``_map_replicas``)."""
    return [gicp.vgicp_linearize(T_target.to(dev), T_source.to(dev), pts, covs, mask,
                                 *maps[dev])
            for dev, pts, covs, mask in _source_shards(mesh, "sharded_vgicp_linearize",
                                                       src_pts, src_covs, src_mask)]


def sharded_vgicp_linearize(mesh: Mesh, T_target, T_source, src_pts, src_covs,
                            src_mask, vm: GaussianVoxelMap) -> gicp.FactorSystem:
    """VGICP linearization with the source points sharded over the mesh and
    the voxel map replicated; the shards' systems (``num_inliers`` too) are
    summed on ``mesh.devices[0]``."""
    parts = _vgicp_shards(mesh, _map_replicas(mesh, vm), T_target, T_source, src_pts,
                          src_covs, src_mask)
    return _psum(parts, mesh.devices[0])


def sharded_gicp_linearize(mesh: Mesh, T_target, T_source, src_pts, src_covs,
                           src_mask, tgt_pts, tgt_covs, tgt_mask, max_dist
                           ) -> gicp.FactorSystem:
    """GICP linearization with the source points sharded and the target
    replicated: each shard calls ``nn_search`` once, so a call launches the
    kernel ``mesh.size`` times (on CUDA tensors)."""
    targets = replicas(mesh, lambda dev: (tgt_pts.to(dev), tgt_covs.to(dev),
                                          tgt_mask.to(dev)))
    parts = [gicp.gicp_linearize(T_target.to(dev), T_source.to(dev), pts, covs, mask,
                                 *targets[dev], float(max_dist))
             for dev, pts, covs, mask in _source_shards(mesh, "sharded_gicp_linearize",
                                                        src_pts, src_covs, src_mask)]
    return _psum(parts, mesh.devices[0])


_VM_FIELDS = tuple(f.name for f in fields(GaussianVoxelMap))


def _vgicp_one(T_t, T_s, pts, covs, mask, *vm_fields):
    return gicp.vgicp_linearize(T_t, T_s, pts, covs, mask, GaussianVoxelMap(*vm_fields))


_vgicp_vmapped = vmap(_vgicp_one)


def sharded_factor_linearize(mesh: Mesh, T_t, T_s, pts, covs, masks,
                             vms_stacked: GaussianVoxelMap) -> gicp.FactorSystem:
    """Global mapping's fan-out: VGICP matching-cost factors sharded over
    the FACTOR axis. Each shard linearizes its slice of submap pairs
    against its slice of the stacked target voxel maps (the per-factor
    ``vgicp_linearize`` vmapped); the stacked per-factor blocks come back
    concatenated in factor order on ``mesh.devices[0]``.

    T_t, T_s (F, 4, 4); pts / covs / masks (F, C, ...); vms_stacked a
    GaussianVoxelMap whose fields carry a leading F axis
    (``voxelmap.stack_voxelmaps``); F a multiple of the mesh size."""
    what = "sharded_factor_linearize"
    args = [shard_slices(mesh, x, what) for x in (T_t, T_s, pts, covs, masks)]
    args += [shard_slices(mesh, getattr(vms_stacked, n), what) for n in _VM_FIELDS]
    parts = [_vgicp_vmapped(*shard) for shard in zip(*args)]
    dev = mesh.devices[0]
    return gicp.FactorSystem(*(torch.cat([x.to(dev) for x in xs]) for xs in zip(*parts)))


def sharded_odometry_step(mesh: Mesh, T_init, src_pts, src_covs, src_mask,
                          vm: GaussianVoxelMap, iters: int = 8):
    """One full odometry registration solve with the point batch sharded
    over the mesh: ``iters`` Gauss-Newton steps on the summed normal
    equations (damping 1e-6). Returns (T (4, 4), errs (iters,)), the error
    of each step's linearization, as JAX's ``lax.scan`` does."""
    dev = mesh.devices[0]
    maps = _map_replicas(mesh, vm)
    eye = torch.eye(4, device=dev)
    T = T_init.to(dev)
    errs = []
    for _ in range(iters):
        sys = _psum(_vgicp_shards(mesh, maps, eye, T, src_pts, src_covs, src_mask), dev)
        delta = solver.solve_damped(sys.H_ss, sys.b_s, 1e-6)
        T = T @ lie.se3_exp(delta)
        errs.append(sys.error)
    return T, torch.stack(errs)
