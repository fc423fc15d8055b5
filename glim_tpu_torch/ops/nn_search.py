"""Exact k=1 nearest-neighbour search: CUDA kernel wrapper and plain version.

Counterpart of ``glim_tpu/ops/pallas_knn.py`` (``nn_search_pallas`` and its
body ``_nn_kernel``): the nearest valid target for every valid query of
padded, masked clouds, by ``d2 = |q|^2 + |t|^2 - 2 q.t``, ties to the lowest
index, d2 clamped >= 0 at the end, invalid queries -> (0, +inf).

``nn_search`` dispatches on where its tensors lie: CPU tensors go to
``nn_search_plain``; CUDA tensors launch the hand-written kernel in
``glim_tpu_torch/csrc/nn_search.cu`` or raise — there is no fallback. Each
launch adds one to ``nn_search.kernel_launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from glim_tpu_torch.utils.cuda_build import load_kernel_library

# (query rows x targets) per plain-version tile: cache-sized on the CPU,
# large on the card.
_PLAIN_TILE_ELEMS = {"cpu": 1 << 19, "cuda": 1 << 26}


def nn_search_plain(queries: torch.Tensor, query_mask: torch.Tensor,
                    targets: torch.Tensor, target_mask: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of the kernel: the same expansion
    (|q|^2 + |t|^2) - 2 q.t, the first argmin, and the clamp after the
    search, as the Pallas kernel does. Only valid queries and targets enter
    the distance tiles (tiled over query rows); the targets keep their
    order, so ties still resolve to the lowest index."""
    Q = queries.shape[0]
    dev = queries.device
    idx = torch.zeros(Q, dtype=torch.int32, device=dev)
    d2 = torch.full((Q,), float("inf"), device=dev)
    t_ids = torch.nonzero(target_mask).flatten()
    q_ids = torch.nonzero(query_mask).flatten()
    if len(t_ids) == 0 or len(q_ids) == 0:
        return idx, d2
    t = targets[t_ids]
    t_sq = torch.sum(t * t, dim=-1)
    rows = max(1, _PLAIN_TILE_ELEMS.get(dev.type, 1 << 19) // len(t_ids))
    for s in range(0, len(q_ids), rows):
        ids = q_ids[s:s + rows]
        q = queries[ids]
        q_sq = torch.sum(q * q, dim=-1, keepdim=True)
        best, arg = torch.min(torch.addmm(q_sq + t_sq[None, :], q, t.T, alpha=-2.0),
                              dim=1)                             # first minimum
        d2[ids] = torch.clamp(best, min=0.0)
        idx[ids] = t_ids[arg].to(torch.int32)
    return idx, d2


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library("nn_search")
        lib.glim_nn_search.restype = ctypes.c_int
        lib.glim_nn_search.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p]
        lib.glim_cuda_error_string.restype = ctypes.c_char_p
        lib.glim_cuda_error_string.argtypes = [ctypes.c_int]
        _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"nn_search: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"nn_search: {name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"nn_search: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"nn_search: {name} must be contiguous")


def nn_search(queries: torch.Tensor, query_mask: torch.Tensor,
              targets: torch.Tensor, target_mask: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nearest target per query -> (idx (Q,) int32, d2 (Q,) f32)."""
    dev = queries.device
    if dev.type == "cpu":
        return nn_search_plain(queries, query_mask, targets, target_mask)
    if dev.type != "cuda":
        raise ValueError(f"nn_search: unsupported device {dev}")
    Q, N = int(queries.shape[0]), int(targets.shape[0])
    _check(queries, "queries", torch.float32, (Q, 3), dev)
    _check(query_mask, "query_mask", torch.bool, (Q,), dev)
    _check(targets, "targets", torch.float32, (N, 3), dev)
    _check(target_mask, "target_mask", torch.bool, (N,), dev)
    if Q >= 2**31 or N >= 2**31:
        raise ValueError("nn_search: Q and N must fit in int32")

    lib = _library()
    t_sq = torch.where(target_mask, torch.sum(targets * targets, dim=-1), float("inf"))
    targets_xyzw = torch.cat([targets, t_sq[:, None]], dim=1).contiguous()
    out_idx = torch.empty(Q, dtype=torch.int32, device=dev)
    out_d2 = torch.empty(Q, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.glim_nn_search(queries.data_ptr(), query_mask.data_ptr(),
                                targets_xyzw.data_ptr(), Q, N,
                                out_idx.data_ptr(), out_d2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("nn_search kernel launch failed: "
                           f"{lib.glim_cuda_error_string(rc).decode()} ({rc})")
    nn_search.kernel_launches += 1
    return out_idx, out_d2


nn_search.kernel_launches = 0
