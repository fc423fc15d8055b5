"""Mapping callback slots (reference: include/glim/mapping/callbacks.hpp:30-153).

Numpy-side copy of ``glim_tpu/mapping/callbacks.py``'s sub-mapping and
global-mapping slots; payloads are the glim_tpu_torch data types."""

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


class GlobalMappingCallbacks:
    # (stamp, image)
    on_insert_image = CallbackSlot("global.on_insert_image")
    # (stamp, linear_acc (3,), angular_vel (3,))
    on_insert_imu = CallbackSlot("global.on_insert_imu")
    # (submap: SubMap)
    on_insert_submap = CallbackSlot("global.on_insert_submap")
    # (submaps: List[SubMap]) — fired after optimization updates poses.
    on_update_submaps = CallbackSlot("global.on_update_submaps")
    # (graph_state, new_factors, new_values) — before an optimizer update.
    on_smoother_update = CallbackSlot("global.on_smoother_update")
    # (graph_state, result) — after an optimizer update.
    on_smoother_update_result = CallbackSlot("global.on_smoother_update_result")
    # Inverse-direction request slots (reference: callbacks.hpp:139-152).
    request_to_optimize = CallbackSlot("global.request_to_optimize")
    request_to_recover = CallbackSlot("global.request_to_recover")
    # (min_overlap: float)
    request_to_find_overlapping_submaps = CallbackSlot("global.request_to_find_overlapping_submaps")
    # Factor-injection slots:
    # (submap_idx: int, position (3,) map frame, sqrt_info scalar or (3,))
    request_to_add_translation_prior = CallbackSlot(
        "global.request_to_add_translation_prior")
    # (tgt: int, src: int) — explicit loop-closure pair from a detector.
    request_to_add_loop = CallbackSlot("global.request_to_add_loop")
    # (tgt: int, src: int, T_tgt_src (4,4), info (6,6) or scalar) — manual
    # between-factor injection with an explicit relative-pose measurement.
    request_to_add_between = CallbackSlot("global.request_to_add_between")
