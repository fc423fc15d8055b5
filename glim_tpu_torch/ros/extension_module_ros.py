"""ROS extension module base (topic subscription plumbing), twin of
``glim_tpu/ros/extension_module_ros.py``.

Equivalent surface to the reference's ``ExtensionModuleROS2`` /
``GenericTopicSubscription`` (reference:
include/glim/util/extension_module_ros2.hpp:11-80 and the ROS1 twin):
extension modules declare typed topic subscriptions which the node binds to
a live node or feeds from serialized bag replay. Nothing here imports
rclpy / rospy, so the package works on hosts without ROS.
"""

from __future__ import annotations

from typing import Any, Callable, List

from glim_tpu_torch.utils.extension_module import ExtensionModule


class GenericTopicSubscription:
    """Type-erased subscription the node can bind to a ROS node or a replayer."""

    def __init__(self, topic: str):
        self.topic = topic

    def create_subscriber(self, node) -> None:
        raise NotImplementedError

    def insert_message_instance(self, msg: Any) -> None:
        """Bag-replay path: feed a deserialized message directly."""
        raise NotImplementedError


class TopicSubscription(GenericTopicSubscription):
    def __init__(self, topic: str, msg_type: Any, callback: Callable[[Any], None],
                 qos_depth: int = 10):
        super().__init__(topic)
        self.msg_type = msg_type
        self.callback = callback
        self.qos_depth = qos_depth
        self._sub = None

    def create_subscriber(self, node) -> None:
        # rclpy node duck-typing; ROS1 users pass a rospy-like shim.
        self._sub = node.create_subscription(self.msg_type, self.topic,
                                             self.callback, self.qos_depth)

    def insert_message_instance(self, msg: Any) -> None:
        if isinstance(msg, self.msg_type) or self.msg_type is Any:
            self.callback(msg)


class ExtensionModuleROS(ExtensionModule):
    """Extension modules needing ROS topics override create_subscriptions."""

    def create_subscriptions(self) -> List[GenericTopicSubscription]:
        return []
