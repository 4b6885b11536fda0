from spgan_tpu_torch.infer.managers import CloseLoopPanoramaManager  # noqa: F401
