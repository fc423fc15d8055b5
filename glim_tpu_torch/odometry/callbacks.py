"""Odometry callback slots (reference: include/glim/odometry/callbacks.hpp:28-145).

Slot names and firing points mirror the reference so extension modules port
over; payloads are the glim_tpu data types.
"""

from glim_tpu_torch.utils.callbacks import CallbackSlot


class InsertionCallbacks:
    """Low-latency scan-insertion results (reference: callbacks.hpp:30-42)."""

    # (frame: PreprocessedFrame, T_odom_lidar: np.ndarray (4,4))
    on_updated = CallbackSlot("on_updated")
    # (frame: EstimationFrame)
    on_finished = CallbackSlot("on_finished")


class OdometryEstimationCallbacks:
    # (stamp: float, image)
    on_insert_image = CallbackSlot("odom.on_insert_image")
    # (stamp: float, linear_acc (3,), angular_vel (3,))
    on_insert_imu = CallbackSlot("odom.on_insert_imu")
    # (frame: PreprocessedFrame)
    on_insert_frame = CallbackSlot("odom.on_insert_frame")
    # (frame: EstimationFrame) — fired right after a new frame is estimated.
    on_new_frame = CallbackSlot("odom.on_new_frame")
    # (frame: EstimationFrame) — fired when the new frame's state is updated.
    on_update_new_frame = CallbackSlot("odom.on_update_new_frame")
    # (frames: List[EstimationFrame])
    on_update_frames = CallbackSlot("odom.on_update_frames")
    # (keyframes: List[EstimationFrame])
    on_update_keyframes = CallbackSlot("odom.on_update_keyframes")
    # (marginalized_frames: List[EstimationFrame])
    on_marginalized_frames = CallbackSlot("odom.on_marginalized_frames")
    # (marginalized_keyframes: List[EstimationFrame])
    on_marginalized_keyframes = CallbackSlot("odom.on_marginalized_keyframes")
    # (smoother) — fired after each smoother/window update.
    on_smoother_update = CallbackSlot("odom.on_smoother_update")
    on_smoother_update_finish = CallbackSlot("odom.on_smoother_update_finish")
    # (stamp: float) — fired when the estimator detects an inconsistent window.
    on_smoother_corruption = CallbackSlot("odom.on_smoother_corruption")
    # () — inverse-direction slot: viewers ask for marginal covariances.
    request_to_compute_covariances = CallbackSlot("odom.request_to_compute_covariances")
