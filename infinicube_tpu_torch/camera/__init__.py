"""Camera conventions, the pinhole model and projection; counterpart of
``infinicube_tpu/camera/``."""
