"""Image-based explicit loop detection extension.

Twin of ``glim_tpu/ext/image_loop.py`` (glim_ext's dbow_loop_detector
role): a dense HOG-style global descriptor of each submap's camera image
(8 x 8 cells of 8 soft-assigned gradient-orientation bins, per-cell and
global L2 normalisation) and place matching as one cosine-similarity
matmul against the whole descriptor database.

``_to_gray64`` stays host numpy; the descriptor and the query run on the
module's device, and a query's similarities are read back once.

Wiring: ``GlobalMappingCallbacks.on_insert_image`` buffers recent frames;
``on_insert_submap`` pairs each new submap with the image nearest its
middle frame's stamp, queries the database (temporal exclusion, similarity
threshold, best / second-best ratio) and fires ``request_to_add_loop(tgt,
src)``.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from glim_tpu_torch.mapping.callbacks import GlobalMappingCallbacks as GCB
from glim_tpu_torch.types import to_numpy, upload
from glim_tpu_torch.utils.extension_module import ExtensionModule, config_getter
from glim_tpu_torch.utils.logging import create_module_logger
from glim_tpu_torch.utils.registry import register_module

logger = create_module_logger("img_loop")

_SIZE = 64          # descriptor input resolution (square)
_CELLS = 8          # cells per side
_BINS = 8           # orientation bins
DESC_DIM = _CELLS * _CELLS * _BINS


def _to_gray64(image: np.ndarray) -> np.ndarray:
    """Any (H, W[, C]) image -> (64, 64) float32 by channel mean and a
    full-field box resample (host numpy)."""
    img = np.asarray(image)
    if img.ndim == 3:
        img = img.mean(axis=2)
    img = img.astype(np.float32)

    def resample_axis(a, n, axis):
        size = a.shape[axis]
        if size <= n:   # nearest upsample
            idx = np.minimum((np.arange(n) * size) // n, size - 1)
            return np.take(a, idx, axis=axis)
        edges = (np.arange(n + 1) * size) // n
        csum = np.cumsum(a, axis=axis)
        csum = np.concatenate([np.zeros_like(np.take(csum, [0], axis=axis)), csum],
                              axis=axis)
        hi = np.take(csum, edges[1:], axis=axis)
        lo = np.take(csum, edges[:-1], axis=axis)
        cnt = (edges[1:] - edges[:-1]).astype(np.float32)
        shape = [1, 1]
        shape[axis] = n
        return (hi - lo) / cnt.reshape(shape)

    return resample_axis(resample_axis(img, _SIZE, 0), _SIZE, 1)


def image_descriptor(gray: torch.Tensor) -> torch.Tensor:
    """(64, 64) grayscale -> (DESC_DIM,) L2-normalised HOG-grid descriptor:
    central-difference gradients, soft-assigned orientation histograms per
    8 x 8 cell, per-cell L2 normalisation, global L2 normalisation."""
    g = gray / (torch.max(gray) + 1e-6)
    gx = torch.zeros_like(g)
    gy = torch.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    binf = (torch.atan2(gy, gx) + math.pi) / (2 * math.pi) * _BINS
    b0 = torch.floor(binf).to(torch.int64) % _BINS
    w1 = binf - torch.floor(binf)
    cs = _SIZE // _CELLS

    def cellize(x):
        return x.reshape(_CELLS, cs, _CELLS, cs).permute(0, 2, 1, 3).reshape(
            _CELLS, _CELLS, cs * cs)

    m_c, b_c, w_c = cellize(mag), cellize(b0), cellize(w1)
    oh0 = torch.nn.functional.one_hot(b_c, _BINS).to(g.dtype) * (m_c * (1 - w_c))[..., None]
    oh1 = torch.nn.functional.one_hot((b_c + 1) % _BINS, _BINS).to(g.dtype) \
        * (m_c * w_c)[..., None]
    hist = torch.sum(oh0 + oh1, dim=2)                 # (CELLS, CELLS, BINS)
    hist = hist / (torch.linalg.norm(hist, dim=-1, keepdim=True) + 1e-6)
    desc = hist.reshape(-1)
    return desc / (torch.linalg.norm(desc) + 1e-9)


def database_query(db: torch.Tensor, q: torch.Tensor):
    """(N, D) database x (D,) query -> (similarities (N,), argmax)."""
    sims = db @ q
    return sims, torch.argmax(sims)


class ImageLoopDetector(ExtensionModule):
    """Visual place-recognition loop detector over submaps."""

    def __init__(self, similarity_threshold: float = 0.88, ratio_threshold: float = 1.03,
                 exclude_recent: int = 3, image_buffer: int = 64, device="cuda"):
        self.similarity_threshold = similarity_threshold
        # Best / second-best margin: a genuine revisit beats the best wrong
        # place by a clear gap; perceptual aliasing does not.
        self.ratio_threshold = ratio_threshold
        self.exclude_recent = exclude_recent
        self.image_buffer = image_buffer
        self.device = torch.device(device)
        self._images: List[Tuple[float, np.ndarray]] = []   # (stamp, gray64)
        # on_insert_image fires on the caller's thread while _image_for runs
        # on the global-mapping worker.
        self._images_lock = threading.Lock()
        self.descriptors: List[torch.Tensor] = []            # on the device
        self.submap_ids: List[int] = []
        self.matches: List[tuple] = []                       # (tgt, src, sim)
        self._h_img = GCB.on_insert_image.add(self._on_image)
        self._h_sub = GCB.on_insert_submap.add(self._on_new_submap)

    def detach(self) -> None:
        if self._h_img is not None:
            GCB.on_insert_image.remove(self._h_img)
            GCB.on_insert_submap.remove(self._h_sub)
            self._h_img = self._h_sub = None

    def _on_image(self, stamp: float, image) -> None:
        if hasattr(image, "to_array"):   # undecoded image message
            image = image.to_array()
        try:
            gray = _to_gray64(image)
        except (ValueError, TypeError) as e:     # malformed input: reported, skipped
            logger.warning("image conversion failed (%s %s): %s", type(image).__name__,
                           getattr(image, "shape", "?"), e)
            return
        with self._images_lock:
            self._images.append((float(stamp), gray))
            if len(self._images) > self.image_buffer:
                self._images.pop(0)

    def _image_for(self, stamp: float) -> Optional[np.ndarray]:
        with self._images_lock:
            images = list(self._images)
        if not images:
            return None
        i = int(np.argmin([abs(s - stamp) for s, _ in images]))
        s, gray = images[i]
        return gray if abs(s - stamp) < 5.0 else None

    def _on_new_submap(self, submap) -> None:
        if not submap.frames:
            return
        gray = self._image_for(float(submap.frames[len(submap.frames) // 2].stamp))
        if gray is None:
            return
        desc = image_descriptor(upload(gray, self.device))
        cur = len(self.descriptors)
        self.descriptors.append(desc)
        self.submap_ids.append(int(submap.id))

        n_hist = cur - self.exclude_recent
        if n_hist <= 0:
            return
        sims, _ = database_query(torch.stack(self.descriptors[:n_hist]), desc)
        sims = to_numpy(sims)
        best = int(np.argmax(sims))
        if sims[best] < self.similarity_threshold:
            return
        second = float(np.partition(sims, -2)[-2]) if n_hist > 1 else 0.0
        if second > 1e-6 and sims[best] / second < self.ratio_threshold:
            return
        logger.info("image loop %d -> %d (sim %.3f)", self.submap_ids[best],
                    self.submap_ids[cur], float(sims[best]))
        self.matches.append((best, cur, float(sims[best])))
        GCB.request_to_add_loop(self.submap_ids[best], self.submap_ids[cur])


@register_module("extension", "image_loop")
def create_extension_module(*args, device="cuda", **kwargs):
    g = config_getter("image_loop")
    return ImageLoopDetector(
        similarity_threshold=float(g("similarity_threshold", 0.88)),
        ratio_threshold=float(g("ratio_threshold", 1.03)),
        exclude_recent=int(g("exclude_recent", 3)),
        image_buffer=int(g("image_buffer", 64)), device=device)
