"""Convert a ROS bag (ROS1 .bag, rosbag2 .db3, or MCAP) into a glim_runner
dataset (twin of ``glim_tpu/tools/bag_converter.py``).

    python -m glim_tpu_torch.tools.bag_converter <bag> <out_dir>
        [--points-topic /os_cloud_node/points] [--imu-topic /os_cloud_node/imu]
        [--list]

One-command ingest of the reference's canonical input (an Ouster rosbag,
reference docs/quickstart.md:40-79) without a ROS installation: messages are
decoded by the pure-Python readers in ``io/rosbag.py``, PointCloud2 fields
auto-discovered by the converter (``ros/cloud_converter.py``), and the output
directory (scans/NNNNNN.npy + times/NNNNNN.npy + stamps.csv + imu.csv) feeds
straight into ``tools/glim_runner.py``."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("bag", help="ROS1 .bag / rosbag2 directory / .db3 / .mcap")
    ap.add_argument("out", nargs="?", help="output dataset directory")
    ap.add_argument("--points-topic", default=None)
    ap.add_argument("--imu-topic", default=None)
    ap.add_argument("--list", action="store_true", help="list topics and exit")
    args = ap.parse_args(argv)

    from glim_tpu_torch.io.rosbag import bag_topics, iter_sensor_messages

    if args.list:
        for topic, (typ, count) in sorted(bag_topics(args.bag).items()):
            print(f"{topic:40s} {typ:40s} {count}")
        return 0
    if not args.out:
        ap.error("out directory required (or use --list)")

    os.makedirs(os.path.join(args.out, "scans"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "times"), exist_ok=True)
    stamps = []
    imu_rows = []
    n = 0
    for kind, msg in iter_sensor_messages(args.bag, args.points_topic,
                                          args.imu_topic):
        if kind == "points":
            np.save(os.path.join(args.out, "scans", f"{n:06d}.npy"),
                    np.asarray(msg.points, np.float32))
            if msg.times is not None:
                np.save(os.path.join(args.out, "times", f"{n:06d}.npy"),
                        np.asarray(msg.times, np.float64))
            stamps.append(msg.stamp)
            n += 1
        else:
            imu_rows.append(np.concatenate([[msg.stamp],
                                            msg.linear_acceleration,
                                            msg.angular_velocity]))
    np.savetxt(os.path.join(args.out, "stamps.csv"),
               np.asarray(stamps), delimiter=",")
    if imu_rows:
        np.savetxt(os.path.join(args.out, "imu.csv"),
                   np.stack(imu_rows), delimiter=",")
    print(f"converted {n} scans, {len(imu_rows)} IMU samples -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
