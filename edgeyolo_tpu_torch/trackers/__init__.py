"""Multi-object tracking over per-frame Results (edgeyolo_tpu/trackers): host numpy and scipy."""
