"""StyleGAN2-style op library, NHWC (counterpart of spgan_tpu/ops)."""
