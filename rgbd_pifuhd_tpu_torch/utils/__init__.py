"""Options, checkpoints (read and written), device selection, image
codecs and OpenCV's image operations in NumPy, training logs."""
