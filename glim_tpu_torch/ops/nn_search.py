"""Exact k=1 nearest-neighbour search: CUDA kernel wrapper and plain version.

Counterpart of ``glim_tpu/ops/pallas_knn.py`` (``nn_search_pallas`` and its
body ``_nn_kernel``): the nearest valid target for every valid query of
padded, masked clouds, by ``d2 = |q|^2 + |t|^2 - 2 q.t``, ties to the lowest
index, d2 clamped >= 0 at the end, invalid queries -> (0, +inf).

``nn_search`` dispatches on where its tensors lie: CPU tensors go to
``nn_search_plain``; CUDA tensors launch the hand-written kernel in
``glim_tpu_torch/csrc/nn_search.cu`` or raise — there is no fallback. Each
call that launches it adds one to ``nn_search.kernel_launches`` (the kernel
is three device launches: pack, split search, merge).

The kernel splits the targets across blocks; ``launch_geometry`` picks the
split from Q, N and the SM count, and the merge keeps the lowest index on
ties across splits.
"""

from __future__ import annotations

import ctypes
import functools
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


# The kernel's tiling (csrc/nn_search.cu; checked against the library when
# it loads): a search block's threads, each holding QUERY_ROWS queries in
# registers (thread i of block b holds queries b * QUERIES_PER_BLOCK + i +
# r * QUERY_THREADS), and the targets of a shared-memory tile. A split is a
# whole number of tiles.
QUERY_THREADS = 128
QUERY_ROWS = 8
QUERIES_PER_BLOCK = QUERY_THREADS * QUERY_ROWS
TARGET_TILE = 512
BLOCKS_PER_SM = 4        # search blocks wanted on every SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def launch_geometry(Q: int, N: int, n_sm: int) -> Tuple[int, int, int]:
    """(query blocks, target splits S, targets a split) for the search grid:
    S is the fewest splits that give at least BLOCKS_PER_SM blocks for
    every SM, capped at one tile a split; every split holds targets when
    N > 0, and one empty split stands for N = 0."""
    q_blocks = max(1, _cdiv(Q, QUERIES_PER_BLOCK))
    n_tiles = max(1, _cdiv(N, TARGET_TILE))
    wanted = min(n_tiles, _cdiv(BLOCKS_PER_SM * n_sm, q_blocks))
    tiles_per_split = _cdiv(n_tiles, wanted)
    return q_blocks, _cdiv(n_tiles, tiles_per_split), tiles_per_split * TARGET_TILE


_lib = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = load_kernel_library("nn_search")
        lib.glim_nn_search.restype = ctypes.c_int
        lib.glim_nn_search.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                       + [ctypes.c_void_p] * 4)
        lib.glim_nn_search_scratch_bytes.restype = ctypes.c_int64
        lib.glim_nn_search_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.glim_nn_search_tiling.restype = None
        lib.glim_nn_search_tiling.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.glim_cuda_error_string.restype = ctypes.c_char_p
        lib.glim_cuda_error_string.argtypes = [ctypes.c_int]
        qpb, tile = ctypes.c_int(), ctypes.c_int()
        lib.glim_nn_search_tiling(ctypes.byref(qpb), ctypes.byref(tile))
        if (qpb.value, tile.value) != (QUERIES_PER_BLOCK, TARGET_TILE):
            raise RuntimeError(f"nn_search: the kernel tiles {qpb.value} queries x "
                               f"{tile.value} targets, the wrapper expects "
                               f"{QUERIES_PER_BLOCK} x {TARGET_TILE}")
        _lib = lib
    return _lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    out_idx = torch.empty(Q, dtype=torch.int32, device=dev)
    out_d2 = torch.empty(Q, dtype=torch.float32, device=dev)
    if Q == 0:
        return out_idx, out_d2
    _, splits, split_len = launch_geometry(Q, N, _sm_count(dev.index))
    scratch = torch.empty(lib.glim_nn_search_scratch_bytes(Q, N, splits),
                          dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.glim_nn_search(queries.data_ptr(), query_mask.data_ptr(),
                                targets.data_ptr(), target_mask.data_ptr(), Q, N,
                                splits, split_len, scratch.data_ptr(),
                                out_idx.data_ptr(), out_d2.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("nn_search kernel launch failed: "
                           f"{lib.glim_cuda_error_string(rc).decode()} ({rc})")
    nn_search.kernel_launches += 1
    return out_idx, out_d2


nn_search.kernel_launches = 0
