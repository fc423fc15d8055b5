"""Mapping callback slots (reference: include/glim/mapping/callbacks.hpp:30-153).

Numpy-side copy of ``glim_tpu/mapping/callbacks.py``'s sub-mapping slots;
payloads are the glim_tpu_torch data types."""

from glim_tpu_torch.utils.callbacks import CallbackSlot


class SubMappingCallbacks:
    # (stamp, image)
    on_insert_image = CallbackSlot("sub.on_insert_image")
    # (stamp, linear_acc (3,), angular_vel (3,))
    on_insert_imu = CallbackSlot("sub.on_insert_imu")
    # (frame: EstimationFrame)
    on_insert_frame = CallbackSlot("sub.on_insert_frame")
    # (id: int, keyframe: EstimationFrame)
    on_new_keyframe = CallbackSlot("sub.on_new_keyframe")
    # (graph, values) — fired before submap batch optimization.
    on_optimize_submap = CallbackSlot("sub.on_optimize_submap")
    # (status, values) — per-iteration optimizer status.
    on_optimization_status = CallbackSlot("sub.on_optimization_status")
    # (submap: SubMap)
    on_new_submap = CallbackSlot("sub.on_new_submap")
