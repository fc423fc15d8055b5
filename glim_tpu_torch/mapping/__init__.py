"""Sub-mapping: marginalized odometry frames bundled into submaps."""
