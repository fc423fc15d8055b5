"""Host-side scan packing and PLY IO."""

from glim_tpu_torch.native.loader import ply_read, ply_write  # noqa: F401
from glim_tpu_torch.native.pack import pack_scan_i16  # noqa: F401
