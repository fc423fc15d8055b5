"""Bundled extension modules (the glim_ext ecosystem analogue).

Twin of ``glim_tpu/ext/``: ``scan_context``, ``image_loop``,
``gnss_global`` and ``velocity_suppressor`` (plus
``common/imu_validation.py`` and ``viewer/``). They communicate with the
pipeline only through the callback and request slots. Load them through
``GlimTorch(extension_modules=[...])`` with the reference's names, e.g.
``"libscan_context_loop_detector.so"``.
"""
