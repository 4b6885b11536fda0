from spgan_tpu_torch.infer.managers import InfiniteGenerationManager  # noqa: F401
