"""ROS 2 front end of the port: message conversion, IMU conditioning, the
live node and its rviz publisher (rclpy is imported only by ``node.main``)."""
