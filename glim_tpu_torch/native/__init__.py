"""Host-side scan packing."""

from glim_tpu_torch.native.pack import pack_scan_i16  # noqa: F401
