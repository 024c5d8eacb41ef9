"""Training: losses and the train step (port of ``stair_tpu/train``)."""
