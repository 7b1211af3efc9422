"""Multi-device reorder over torch.distributed (port of
spring_tpu/parallel/)."""
