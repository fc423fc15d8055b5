"""Preprocessing callback slots (reference: include/glim/preprocess/callbacks.hpp:18-39)."""

from glim_tpu_torch.utils.callbacks import CallbackSlot


class PreprocessCallbacks:
    # (raw_points: RawPoints) — fired when a raw frame enters the preprocessor.
    on_raw_points_received = CallbackSlot("on_raw_points_received")
    # (points) — fired before any filtering.
    on_preprocessing_begin = CallbackSlot("on_preprocessing_begin")
    # (points) — fired after downsampling.
    on_downsampling_finished = CallbackSlot("on_downsampling_finished")
    # (points) — fired after distance/crop/outlier filtering.
    on_filtering_finished = CallbackSlot("on_filtering_finished")
